"""Card discovery behind a mockable interface: the port's counterpart of
the JAX package's deviceplugin/devutil.py.

An NVIDIA card appears as the char device `/dev/nvidia<N>`; the kernel
module's other nodes (`nvidiactl`, `nvidia-uvm`, `nvidia-modeset`, ...)
are not cards. The module lists each card under
`/proc/driver/nvidia/gpus/<pci>/`, whose `information` file names its
minor number (`Device Minor:`) and model (`Model:`); NUMA comes from
`/sys/bus/pci/devices/<pci>/numa_node`. Where `/proc/driver/nvidia/gpus`
is absent (in a container, or on a host that hides it), each card's PCI
address, UUID and model come from NVML (utils/nvml.py), keyed by minor
number.
Every root is configurable, so tests build fake trees in temporary
directories, and the NVML session is injectable.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import stat

from container_engine_accelerators_tpu_torch.utils import nvml as nvml_mod

log = logging.getLogger(__name__)

CHIP_RE = re.compile(r"^nvidia(\d+)$")
DEFAULT_DEV_ROOT = "/dev"
DEFAULT_PROC_GPUS_ROOT = "/proc/driver/nvidia/gpus"
DEFAULT_SYSFS_PCI_ROOT = "/sys/bus/pci/devices"


@dataclasses.dataclass(frozen=True)
class Chip:
    index: int
    dev_path: str            # /dev/nvidia0
    numa_node: int | None    # None if unknown / single-node host
    pci_address: str | None  # 0000:18:00.0
    # GPU-<uuid>, where the driver or NVML names it. Metadata: two
    # discoveries of one node compare equal whatever it holds.
    uuid: str | None = dataclasses.field(default=None, compare=False)


class DeviceInfo:
    """Interface: concrete impls are SysfsDeviceInfo and MockDeviceInfo."""

    def discover(self) -> list[Chip]:
        raise NotImplementedError

    def chip_generation(self) -> str:
        raise NotImplementedError


def _chip_nodes(dev_root: str) -> list[tuple[int, str]]:
    """(index, path) of each nvidia<N> name under dev_root."""
    try:
        entries = sorted(os.listdir(dev_root))
    except FileNotFoundError:
        return []
    return [(int(m.group(1)), os.path.join(dev_root, name))
            for name in entries if (m := CHIP_RE.match(name))]


def _is_device_node(path: str) -> bool:
    """Real cards are char devices; plain files are accepted so fake
    trees in tests need no mknod (root-only)."""
    try:
        mode = os.stat(path).st_mode
    except OSError:
        return False
    return stat.S_ISCHR(mode) or stat.S_ISREG(mode)


def _read_information(path: str) -> dict[str, str]:
    fields = {}
    try:
        with open(path) as f:
            for line in f:
                key, sep, value = line.partition(":")
                if sep:
                    fields[key.strip()] = value.strip()
    except OSError:
        pass
    return fields


class SysfsDeviceInfo(DeviceInfo):
    """Discovery over a dev root. Card metadata (PCI address, UUID,
    model) comes from the driver's /proc files, or, where those are
    absent, from `nvml`: an open utils.nvml.Nvml, or None to open one on
    first need. A host without NVML then has no metadata, as a host
    without the /proc files had before."""

    def __init__(self, dev_root: str = DEFAULT_DEV_ROOT,
                 proc_gpus_root: str = DEFAULT_PROC_GPUS_ROOT,
                 sysfs_pci_root: str = DEFAULT_SYSFS_PCI_ROOT,
                 nvml=None):
        self.dev_root = dev_root
        self.proc_gpus_root = proc_gpus_root
        self.sysfs_pci_root = sysfs_pci_root
        self._nvml = nvml
        self._nvml_tried = nvml is not None

    def nvml(self):
        """The NVML session, opened on first call; None (NVML's error
        logged once) where NVML cannot be loaded or initialised."""
        if not self._nvml_tried:
            self._nvml_tried = True
            try:
                self._nvml = nvml_mod.Nvml()
            except nvml_mod.NvmlError as e:
                log.warning("no card metadata from NVML: %s", e)
        return self._nvml

    def _driver_cards(self) -> dict[int, tuple[str | None, dict[str, str]]]:
        """Device minor -> (PCI address, fields of its information
        file), from /proc/driver/nvidia/gpus; where that is absent, the
        same fields from NVML ('Model', 'GPU UUID')."""
        try:
            entries = sorted(os.listdir(self.proc_gpus_root))
        except OSError:
            entries = None
        if entries is None:
            session = self.nvml()
            if session is None:
                return {}
            return {minor: (card.pci_address,
                            {"Model": card.name, "GPU UUID": card.uuid})
                    for minor, card in session.cards().items()}
        cards = {}
        for pci in entries:
            info = _read_information(
                os.path.join(self.proc_gpus_root, pci, "information"))
            minor = info.get("Device Minor", "")
            if minor.isdigit():
                cards[int(minor)] = (pci, info)
        return cards

    def discover(self) -> list[Chip]:
        cards = self._driver_cards()
        chips = []
        for idx, path in _chip_nodes(self.dev_root):
            if not _is_device_node(path):
                continue
            pci, info = cards.get(idx, (None, {}))
            chips.append(Chip(index=idx, dev_path=path,
                              numa_node=self._numa_node(pci),
                              pci_address=pci,
                              uuid=info.get("GPU UUID") or None))
        return chips

    def _numa_node(self, pci: str | None) -> int | None:
        if pci is None:
            return None
        try:
            with open(os.path.join(self.sysfs_pci_root, pci,
                                   "numa_node")) as f:
                node = int(f.read().strip())
        except (OSError, ValueError):
            return None
        return node if node >= 0 else None

    def chip_generation(self) -> str:
        """The model line of the lowest card's information file (e.g.
        'NVIDIA H100 80GB HBM3'), or 'unknown'."""
        cards = self._driver_cards()
        if not cards:
            return "unknown"
        return cards[min(cards)][1].get("Model") or "unknown"


class MockDeviceInfo(DeviceInfo):
    """Test double: discovery over a fabricated dev tree, fixed
    metadata."""

    def __init__(self, dev_root: str, numa_nodes: dict[int, int] | None = None,
                 generation: str = "NVIDIA H100 80GB HBM3"):
        self.dev_root = dev_root
        self.numa_nodes = numa_nodes or {}
        self.generation = generation

    def discover(self) -> list[Chip]:
        return [Chip(index=idx, dev_path=path,
                     numa_node=self.numa_nodes.get(idx),
                     pci_address=f"0000:{idx:02x}:00.0",
                     uuid=mock_uuid(idx))
                for idx, path in _chip_nodes(self.dev_root)]

    def chip_generation(self) -> str:
        return self.generation


def mock_uuid(index: int) -> str:
    """The UUID MockDeviceInfo gives card `index`."""
    return f"GPU-{index:08x}-0000-4000-8000-000000000000"


def torch_card_minor(torch, ordinal: int, cards: dict) -> int | None:
    """The minor number of torch's card `ordinal`: the card in `cards`
    ({minor: utils.nvml.CardIdentity}) with its UUID, else its PCI
    address; None where neither matches. torch's ordinal is its own
    (renumbered from 0 under CUDA_VISIBLE_DEVICES, fastest first by
    default), never the /dev/nvidia<N> minor."""
    props = torch.cuda.get_device_properties(ordinal)
    uuid = f"GPU-{props.uuid}"
    for minor, card in cards.items():
        if card.uuid == uuid:
            return minor
    pci = "{:04x}:{:02x}:{:02x}.0".format(
        props.pci_domain_id, props.pci_bus_id, props.pci_device_id)
    for minor, card in cards.items():
        if card.pci_address == pci:
            return minor
    return None
