"""Card device manager: discovery, the advertised devices and the health
fan-out to listeners. The port's counterpart of the JAX package's
deviceplugin/manager.py (TPUManager, from construction to
chips_for_device), over `/dev/nvidia<N>` cards.

Not here yet: the kubelet gRPC serve loop and its registration, the
allocation answers (device specs, mounts, envs) and the plugin service,
which need grpcio and protobuf; ROADMAP lists them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading

from container_engine_accelerators_tpu_torch.deviceplugin import (
    sharing,
    subslice,
)
from container_engine_accelerators_tpu_torch.deviceplugin.config import (
    TIME_SHARING,
    TPUConfig,
)
from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
    Chip,
    DeviceInfo,
    SysfsDeviceInfo,
)
from container_engine_accelerators_tpu_torch.utils.wakeq import WakeQueue

log = logging.getLogger(__name__)

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"
PHYSICAL_PREFIX = "nvidia"


@dataclasses.dataclass
class Device:
    """One advertised device (the kubelet API's Device message)."""
    ID: str
    health: str
    numa: int | None = None


class TPUManager:
    def __init__(self, config: TPUConfig,
                 device_info: DeviceInfo | None = None):
        self.config = config
        self.device_info = device_info or SysfsDeviceInfo()
        self.devices: dict[str, Device] = {}
        self._chips: dict[int, Chip] = {}
        self._subslices: dict[str, subslice.Subslice] = {}
        self._lock = threading.Lock()
        self._listeners: list[WakeQueue] = []
        self._stop = threading.Event()

    # ---------- discovery ----------

    def check_device_paths(self) -> bool:
        """True once at least one card node exists."""
        return bool(self.device_info.discover())

    def discover(self) -> None:
        """Scan the cards and rebuild the advertised device map, keeping
        the health of devices that stay."""
        chips = self.device_info.discover()
        with self._lock:
            old_health = {d.ID: d.health for d in self.devices.values()}
            self._chips = {c.index: c for c in chips}
            self.devices = {}
            self._subslices = {}

            def add(dev_id, numa):
                self.devices[dev_id] = Device(
                    dev_id, old_health.get(dev_id, HEALTHY), numa)

            if self.config.chips_per_partition:
                for sub in subslice.partition(
                        chips, self.config.chips_per_partition):
                    self._subslices[sub.id] = sub
                    add(sub.id, sub.numa_node)
            elif self.config.sharing.strategy == TIME_SHARING:
                n = self.config.sharing.max_shared_clients_per_chip
                for c in chips:
                    phys = os.path.basename(c.dev_path)
                    for i in range(n):
                        add(sharing.virtual_id(phys, i), c.numa_node)
            else:
                for c in chips:
                    add(os.path.basename(c.dev_path), c.numa_node)

    # ---------- health fan-out ----------

    def set_device_health(self, device_id: str, health: str) -> None:
        with self._lock:
            dev = self.devices.get(device_id)
            if dev is None or dev.health == health:
                return
            dev.health = health
            listeners = list(self._listeners)
        log.info("device %s -> %s", device_id, health)
        for q in listeners:
            q.put(None)   # wake each listener to resend the snapshot

    def set_chip_health(self, chip_index: int, health: str) -> None:
        """Flip every advertised device backed by a card (virtual devices
        share fate with their card; subslices with any member)."""
        with self._lock:
            targets = []
            phys = f"{PHYSICAL_PREFIX}{chip_index}"
            for dev_id in self.devices:
                if dev_id == phys or dev_id.startswith(phys + "/"):
                    targets.append(dev_id)
            for sid, sub in self._subslices.items():
                if any(c.index == chip_index for c in sub.chips):
                    targets.append(sid)
        for t in targets:
            self.set_device_health(t, health)

    def chip_indices(self) -> list[int]:
        with self._lock:
            return sorted(self._chips)

    def snapshot(self) -> list[Device]:
        with self._lock:
            return [dataclasses.replace(d) for d in self.devices.values()]

    def add_listener(self) -> WakeQueue:
        q = WakeQueue()
        with self._lock:
            self._listeners.append(q)
        return q

    def remove_listener(self, q) -> None:
        with self._lock:
            if q in self._listeners:
                self._listeners.remove(q)

    # ---------- allocation support ----------

    def chips_for_device(self, device_id: str) -> list[Chip]:
        with self._lock:
            if device_id in self._subslices:
                return list(self._subslices[device_id].chips)
            if sharing.is_virtual_id(device_id):
                device_id = sharing.virtual_to_physical(device_id)
            for c in self._chips.values():
                if os.path.basename(c.dev_path) == device_id:
                    return [c]
        raise KeyError(f"unknown device {device_id!r}")

    def stop(self) -> None:
        """Ask the kubelet serve loop to end (the loop is not ported
        yet; `stopped` reads the request)."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()
