"""Card discovery behind a mockable interface: the port's counterpart of
the JAX package's deviceplugin/devutil.py.

An NVIDIA card appears as the char device `/dev/nvidia<N>`; the kernel
module's other nodes (`nvidiactl`, `nvidia-uvm`, `nvidia-modeset`, ...)
are not cards. The module lists each card under
`/proc/driver/nvidia/gpus/<pci>/`, whose `information` file names its
minor number (`Device Minor:`) and model (`Model:`); NUMA comes from
`/sys/bus/pci/devices/<pci>/numa_node`.
Every root is configurable, so tests build fake trees in temporary
directories.
"""

from __future__ import annotations

import dataclasses
import os
import re
import stat

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
    def __init__(self, dev_root: str = DEFAULT_DEV_ROOT,
                 proc_gpus_root: str = DEFAULT_PROC_GPUS_ROOT,
                 sysfs_pci_root: str = DEFAULT_SYSFS_PCI_ROOT):
        self.dev_root = dev_root
        self.proc_gpus_root = proc_gpus_root
        self.sysfs_pci_root = sysfs_pci_root

    def _driver_cards(self) -> dict[int, tuple[str, dict[str, str]]]:
        """Device minor -> (PCI address, fields of its information file)."""
        try:
            entries = sorted(os.listdir(self.proc_gpus_root))
        except OSError:
            return {}
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
            pci = cards[idx][0] if idx in cards else None
            chips.append(Chip(index=idx, dev_path=path,
                              numa_node=self._numa_node(pci),
                              pci_address=pci))
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
                     pci_address=f"0000:{idx:02x}:00.0")
                for idx, path in _chip_nodes(self.dev_root)]

    def chip_generation(self) -> str:
        return self.generation
