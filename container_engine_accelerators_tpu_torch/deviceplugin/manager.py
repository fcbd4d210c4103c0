"""Card device manager: discovery, the advertised devices, the health
fan-out to listeners, the allocation answers and the kubelet
serve/restart state machine. The port's counterpart of the JAX
package's deviceplugin/manager.py (TPUManager), over `/dev/nvidia<N>`
cards, as the reference's nvidiaGPUManager does it (reference
pkg/gpu/nvidia/manager.go:142-157 state, :237-304 discovery, :442-549
serve loop), with its concurrency a polling loop plus per-stream queues:

  - kubelet wipes /device-plugin/  -> plugin socket vanishes -> restart
    the gRPC server and re-register (manager.go:507-516)
  - kubelet restarts               -> kubelet.sock's identity changes ->
    re-register (manager.go:517-533)
  - a card appears or disappears   -> the advertised set changes ->
    restart so the kubelet resyncs (manager.go:534-545)

The contract a container gets from Allocate differs from the JAX
plugin's by design: the resource is `nvidia.com/gpu`; each card's node
comes with the driver's control nodes; the driver tree is mounted where
the reference mounts it; the cards are named by UUID in
CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures

import grpc

from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
from container_engine_accelerators_tpu_torch.deviceplugin import (
    sharing,
    subslice,
)
from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    RegistrationStub,
    add_device_plugin_servicer,
    deviceplugin_pb2 as pb,
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

DEVICE_PLUGIN_API_VERSION = "v1beta1"
DEFAULT_PLUGIN_DIR = "/device-plugin"
KUBELET_SOCKET = "kubelet.sock"
PLUGIN_SOCKET = "nvidiaGPU.sock"
# The driver tree the installer DaemonSet stages (the reference's
# daemonset.yaml:59-61), mounted read-only where the reference mounts it
# (cmd/nvidia_gpu/nvidia_gpu.go:113-115).
DEFAULT_DRIVER_HOST_DIR = "/home/kubernetes/bin/nvidia"
DEFAULT_DRIVER_CONTAINER_DIR = "/usr/local/nvidia"
# The driver's nodes every container that opens a card needs; the
# reference appends them to each response (beta_plugin.go:77-83).
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset")
# The counterpart of the JAX plugin's TPU_CHIP_GENERATION.
MODEL_ENV = "GPU_CHIP_GENERATION"


class TPUManager:
    def __init__(self, config: TPUConfig,
                 device_info: DeviceInfo | None = None, *,
                 plugin_dir: str = DEFAULT_PLUGIN_DIR,
                 driver_host_dir: str = DEFAULT_DRIVER_HOST_DIR,
                 driver_container_dir: str = DEFAULT_DRIVER_CONTAINER_DIR,
                 resource_name: str = GPU_RESOURCE_NAME,
                 poll_interval: float = 1.0,
                 chip_check_interval: float = 10.0):
        self.config = config
        self.device_info = device_info or SysfsDeviceInfo()
        self.plugin_dir = plugin_dir
        self.driver_host_dir = driver_host_dir
        self.driver_container_dir = driver_container_dir
        self.resource_name = resource_name
        self.poll_interval = poll_interval
        self.chip_check_interval = chip_check_interval

        self.devices: dict[str, pb.Device] = {}
        self._chips: dict[int, Chip] = {}
        self._subslices: dict[str, subslice.Subslice] = {}
        self._lock = threading.Lock()
        # WakeQueue: the ListAndWatch pump does a timed get, which must
        # not lose a health flip's wakeup (utils/wakeq.py).
        self._listeners: list[WakeQueue] = []
        self._stop = threading.Event()
        self.restarts = 0  # observable for tests

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
                self.devices[dev_id] = self._make_device(
                    dev_id, numa, old_health.get(dev_id, HEALTHY))

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

    @staticmethod
    def _make_device(dev_id: str, numa: int | None, health: str) -> pb.Device:
        dev = pb.Device(ID=dev_id, health=health)
        if numa is not None:
            dev.topology.nodes.add(ID=numa)
        return dev

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
            q.put(None)   # wake each ListAndWatch stream to resend

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

    def snapshot(self) -> list[pb.Device]:
        with self._lock:
            return [pb.Device.FromString(d.SerializeToString())
                    for d in self.devices.values()]

    def add_listener(self) -> WakeQueue:
        q = WakeQueue()
        with self._lock:
            self._listeners.append(q)
        return q

    def remove_listener(self, q) -> None:
        with self._lock:
            if q in self._listeners:
                self._listeners.remove(q)

    def wake_listeners(self) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for q in listeners:
            q.put(None)

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

    def device_specs(self, device_ids: list[str]) -> list[pb.DeviceSpec]:
        """Each allocated card's node, once, then the driver's control
        nodes that exist beside them."""
        specs, seen = [], set()
        for dev_id in device_ids:
            for chip in self.chips_for_device(dev_id):
                if chip.dev_path in seen:
                    continue
                seen.add(chip.dev_path)
                specs.append(pb.DeviceSpec(
                    container_path=chip.dev_path,
                    host_path=chip.dev_path,
                    permissions="mrw"))
        dev_root = getattr(self.device_info, "dev_root", "/dev")
        for name in CONTROL_NODES if specs else ():
            path = os.path.join(dev_root, name)
            if os.path.exists(path):
                specs.append(pb.DeviceSpec(container_path=path,
                                           host_path=path, permissions="mrw"))
        return specs

    def mounts(self) -> list[pb.Mount]:
        if not self.driver_host_dir:
            return []
        return [pb.Mount(container_path=self.driver_container_dir,
                         host_path=self.driver_host_dir, read_only=True)]

    def envs(self, device_ids: list[str]) -> dict[str, str]:
        """Which cards the container may open, by UUID: inside a
        container CUDA renumbers them from 0, fastest first, so an index
        names no card; a UUID names it in any namespace. Raises
        ValueError where a card's UUID is not known."""
        chips = sorted({c.index: c for d in device_ids
                        for c in self.chips_for_device(d)}.items())
        missing = [c.dev_path for _, c in chips if not c.uuid]
        if missing:
            raise ValueError(f"no UUID known for {missing}")
        return {
            "CUDA_VISIBLE_DEVICES": ",".join(c.uuid for _, c in chips),
            MODEL_ENV: self.device_info.chip_generation(),
        }

    # ---------- serve state machine ----------

    def stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def serve(self) -> None:
        """Run until stop(): serve the plugin socket, register with the
        kubelet, watch for the three restart triggers. The socket is
        removed on the way out."""
        from container_engine_accelerators_tpu_torch.deviceplugin.plugin_service import (
            DevicePluginService,
        )
        try:
            while not self._stop.is_set():
                try:
                    self._serve_once(DevicePluginService(self))
                except Exception:
                    log.exception("serve loop error; retrying in 2s")
                    self._stop.wait(2.0)
                self.restarts += 1
        finally:
            try:
                os.unlink(os.path.join(self.plugin_dir, PLUGIN_SOCKET))
            except FileNotFoundError:
                pass

    def _serve_once(self, service) -> None:
        sock_path = os.path.join(self.plugin_dir, PLUGIN_SOCKET)
        kubelet_path = os.path.join(self.plugin_dir, KUBELET_SOCKET)
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass

        server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        add_device_plugin_servicer(service, server)
        server.add_insecure_port(f"unix://{sock_path}")
        server.start()
        log.info("device plugin serving on %s", sock_path)
        try:
            # The kubelet socket's identity is the one seen before
            # dialing: taken after registration, a kubelet restart in
            # between would go unnoticed.
            kubelet_id = self._register_with_kubelet(kubelet_path)
            last_chip_check = time.monotonic()
            while not self._stop.is_set():
                self._stop.wait(self.poll_interval)
                if not os.path.exists(sock_path):
                    log.warning("plugin socket removed; restarting server")
                    return
                if self._file_identity(kubelet_path) != kubelet_id:
                    log.warning("kubelet restart detected; re-registering")
                    return
                now = time.monotonic()
                if now - last_chip_check >= self.chip_check_interval:
                    last_chip_check = now
                    before = set(self.devices)
                    self.discover()
                    if set(self.devices) != before:
                        log.warning("advertised devices changed "
                                    "(%d -> %d); restarting server",
                                    len(before), len(self.devices))
                        return
        finally:
            service.stop()
            server.stop(grace=1).wait()

    @staticmethod
    def _file_identity(path: str):
        try:
            st = os.stat(path)
            return (st.st_ino, st.st_ctime)
        except OSError:
            return None

    def _register_with_kubelet(self, kubelet_path: str,
                               timeout: float = 30.0):
        """Register; returns the kubelet socket identity captured before
        dialing (reference beta_plugin.go:110-131). Waits for the socket
        file first: dialing a missing unix socket puts gRPC into connect
        backoff, which can outlast the ready-future timeout after a
        kubelet restart."""
        deadline = time.monotonic() + timeout
        while not os.path.exists(kubelet_path):
            if time.monotonic() > deadline or self._stop.is_set():
                raise TimeoutError(f"kubelet socket {kubelet_path} absent")
            self._stop.wait(0.05)
        identity = self._file_identity(kubelet_path)
        with grpc.insecure_channel(f"unix://{kubelet_path}") as channel:
            grpc.channel_ready_future(channel).result(timeout=10)
            stub = RegistrationStub(channel)
            stub.Register(pb.RegisterRequest(
                version=DEVICE_PLUGIN_API_VERSION,
                endpoint=PLUGIN_SOCKET,
                resource_name=self.resource_name,
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=True),
            ), timeout=10)
        log.info("registered %s with kubelet", self.resource_name)
        return identity
