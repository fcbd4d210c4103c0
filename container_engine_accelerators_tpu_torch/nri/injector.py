"""Device injection from pod annotations.

Contract (identical to the reference so existing manifests keep working,
reference nri_device_injector/nri_device_injector.go:86-199):

  annotations:
    devices.gke.io/container.<container-name>: |
      - path: /dev/nvidia0
      - path: /dev/nvidiactl
      - path: /dev/nvidia-uvm

On CreateContainer, each listed path is stat'ed for char/block type and
major/minor numbers and injected into the container's device list. This is
how sidecar daemons that must see a card without requesting
`nvidia.com/gpu` (the RxDM contract, reference
gpudirect-tcpxo/nccl-test-latest.yaml:41-52) get device access; the
nodes are the ones the device plugin's Allocate returns for a card.

The containerd attachment point is the NRI socket (ttrpc); this module
keeps the protocol-independent core importable and testable, with the
runtime adaptation layered in the DaemonSet entrypoint
(nri_device_injector/ at the repo root).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import stat as stat_mod

import yaml

log = logging.getLogger(__name__)

ANNOTATION_PREFIX = "devices.gke.io/container."


@dataclasses.dataclass(frozen=True)
class Device:
    path: str
    type: str       # 'c' or 'b'
    major: int
    minor: int
    uid: int | None = None
    gid: int | None = None

    def as_nri(self) -> dict:
        d = {"path": self.path, "type": self.type,
             "major": self.major, "minor": self.minor}
        if self.uid is not None:
            d["uid"] = self.uid
        if self.gid is not None:
            d["gid"] = self.gid
        return d


def parse_device_annotations(annotations: dict) -> dict[str, list[str]]:
    """Map container name -> device paths from pod annotations (reference
    getDevices :126-155). Malformed entries raise ValueError: failing
    closed beats silently starting a sidecar without its devices."""
    out: dict[str, list[str]] = {}
    for key, value in (annotations or {}).items():
        if not key.startswith(ANNOTATION_PREFIX):
            continue
        container = key[len(ANNOTATION_PREFIX):]
        if not container:
            raise ValueError(f"annotation {key!r} names no container")
        parsed = yaml.safe_load(value)
        if not isinstance(parsed, list):
            raise ValueError(
                f"annotation {key!r} must be a YAML list of {{path: ...}}")
        paths = []
        for item in parsed:
            if not isinstance(item, dict) or "path" not in item:
                raise ValueError(
                    f"annotation {key!r}: entries need a 'path' key")
            paths.append(str(item["path"]))
        out[container] = paths
    return out


def to_nri_device(path: str) -> Device:
    """Stat a device node (reference toNRIDevice :158-199)."""
    st = os.stat(path)
    if stat_mod.S_ISCHR(st.st_mode):
        dev_type = "c"
    elif stat_mod.S_ISBLK(st.st_mode):
        dev_type = "b"
    else:
        raise ValueError(f"{path} is not a device node")
    return Device(path=path,
                  type=dev_type,
                  major=os.major(st.st_rdev),
                  minor=os.minor(st.st_rdev),
                  uid=st.st_uid, gid=st.st_gid)


def devices_for_container(pod_annotations: dict,
                          container_name: str) -> list[Device]:
    """CreateContainer hook body (reference :86-123)."""
    mapping = parse_device_annotations(pod_annotations)
    paths = mapping.get(container_name, [])
    devices = []
    for path in paths:
        try:
            devices.append(to_nri_device(path))
        except (OSError, ValueError) as e:
            raise ValueError(f"cannot inject {path} into "
                             f"{container_name}: {e}") from None
    if devices:
        log.info("injecting %d devices into container %s",
                 len(devices), container_name)
    return devices


def inject_for_pod(pod_annotations: dict) -> dict[str, list[dict]]:
    """All containers' adjustments for one pod, NRI-shaped."""
    return {
        container: [to_nri_device(p).as_nri() for p in paths]
        for container, paths in
        parse_device_annotations(pod_annotations).items()
    }
