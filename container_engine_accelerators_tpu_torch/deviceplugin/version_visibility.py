"""Publish the NVIDIA driver's version as node annotations under the
reference's prefix, `cloud.google.com/cuda.driver-version` (reference
pkg/gpu/nvidia/version_visibility/version_visibility.go:38-86). The
port's counterpart of the JAX package's deviceplugin/version_visibility.py,
which publishes libtpu's version the same way.

The version comes from the driver tree the installer stages: its
`version` stamp, or else the version in a versioned soname of the
driver's libraries (`libnvidia-ml.so.<x.y.z>`, `libcuda.so.<x.y.z>`)
in the tree or its `lib64/`."""

from __future__ import annotations

import logging
import os
import re
import time

ANNOTATION_PREFIX = "cloud.google.com/cuda.driver-version"
VERSION_RE = re.compile(r"^(\d+)\.(\d+)\.(\d+)")
# NVML ships only with the driver, so its soname comes first; a stale
# libcuda from an image's compat package can sit beside it.
DRIVER_LIBRARIES = ("libnvidia-ml.so", "libcuda.so")
SONAME_RE = re.compile(r"^(libnvidia-ml\.so|libcuda\.so)\.(\d+(?:\.\d+)+)$")

log = logging.getLogger(__name__)


def _soname_versions(directory: str) -> dict[str, list[str]]:
    found: dict[str, list[str]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return found
    for name in names:
        m = SONAME_RE.match(name)
        if m:
            found.setdefault(m.group(1), []).append(m.group(2))
    return found


def read_driver_version(driver_dir: str) -> str | None:
    """`<dir>/version`; else the highest version of the first driver
    library (NVML, then libcuda) found as a versioned soname in the dir
    or its lib64/. A soname of one number (libcuda.so.1) names no
    version."""
    stamp = os.path.join(driver_dir, "version")
    try:
        with open(stamp) as f:
            return f.read().strip()
    except OSError:
        pass
    for directory in (driver_dir, os.path.join(driver_dir, "lib64")):
        found = _soname_versions(directory)
        for lib in DRIVER_LIBRARIES:
            if lib in found:
                return max(found[lib],
                           key=lambda v: tuple(int(p) for p in v.split(".")))
    return None


def version_annotations(version: str) -> dict[str, str]:
    """Split major/minor/revision the way the reference publishes the
    driver's components (version_visibility.go:48-64); a version of two
    parts gets `.full` only."""
    ann = {ANNOTATION_PREFIX + ".full": version}
    m = VERSION_RE.match(version)
    if m:
        ann[ANNOTATION_PREFIX + ".major"] = m.group(1)
        ann[ANNOTATION_PREFIX + ".minor"] = m.group(2)
        ann[ANNOTATION_PREFIX + ".revision"] = m.group(3)
    return ann


def publish_version_annotations(k8s, node_name: str, driver_dir: str) -> bool:
    version = read_driver_version(driver_dir)
    if not version:
        log.warning("no driver version found under %s", driver_dir)
        return False
    k8s.annotate_node(node_name, version_annotations(version))
    log.info("published driver version %s on node %s", version, node_name)
    return True


def publish_version_annotations_forever(
        k8s=None, node_name: str | None = None,
        driver_dir: str = "/home/kubernetes/bin/nvidia",
        interval: float = 600.0):
    from container_engine_accelerators_tpu_torch.k8s import in_cluster_client

    k8s = k8s or in_cluster_client()
    node_name = node_name or os.environ.get("NODE_NAME", "")
    while True:
        try:
            publish_version_annotations(k8s, node_name, driver_dir)
        except Exception:
            log.exception("version annotation publish failed")
        time.sleep(interval)
