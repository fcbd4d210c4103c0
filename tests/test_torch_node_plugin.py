"""The port's kubelet device plugin against the JAX package's, both
served over real gRPC on unix sockets to a kubelet stub, over fake /dev
trees (`accel<N>` for JAX, `nvidia<N>` for the port; IDs compared after
renaming): registration, the ListAndWatch snapshot and its resend on a
health flip, Allocate, GetPreferredAllocation, the three restart
triggers, and cli/device_plugin_main started and stopped.

Differences by design, each asserted below: the resource name
(`nvidia.com/gpu`), the plugin socket's name, the mount (the driver tree
at /usr/local/nvidia), the driver's control nodes after the card nodes,
and the envs (TPU_VISIBLE_CHIPS/TPU_VISIBLE_DEVICES -> the cards' UUIDs
in CUDA_VISIBLE_DEVICES; TPU_CHIP_GENERATION -> GPU_CHIP_GENERATION;
TPU_SKIP_MDS_QUERY has no counterpart)."""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import pytest

from container_engine_accelerators_tpu.deviceplugin import (
    MockDeviceInfo as JMockDeviceInfo,
    SharingConfig as JSharingConfig,
    TPUConfig as JTPUConfig,
    TPUManager as JTPUManager,
)
from container_engine_accelerators_tpu.deviceplugin import config as jconfig
from container_engine_accelerators_tpu.deviceplugin import manager as jmanager
from container_engine_accelerators_tpu.deviceplugin.api import (
    deviceplugin_pb2 as jpb,
)
from container_engine_accelerators_tpu.deviceplugin.plugin_service import (
    DevicePluginService as JDevicePluginService,
)
from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
from container_engine_accelerators_tpu_torch.deviceplugin import (
    HEALTHY,
    UNHEALTHY,
    DevicePluginService,
    MockDeviceInfo,
    SharingConfig,
    TPUConfig,
    TPUManager,
    config,
    devutil,
)
from container_engine_accelerators_tpu_torch.deviceplugin import manager
from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    DevicePluginStub,
    RegistrationServicer,
    add_registration_servicer,
    deviceplugin_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin.devutil import (
    mock_uuid,
)
from tests.test_deviceplugin import KubeletStub

REPO = Path(__file__).resolve().parents[1]
MODEL = "NVIDIA H100 80GB HBM3"
CONTROL = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
LAYOUTS = {
    "plain": {},
    "sharing2": {"sharing": ("time-sharing", 2)},
    "subslice2": {"chips_per_partition": 2},
}


def _rename(device_id: str) -> str:
    return device_id.replace("accel", "nvidia")


def _config(mod, layout):
    kw = dict(LAYOUTS[layout])
    strategy, clients = kw.pop("sharing", ("", 0))
    return mod.TPUConfig(sharing=mod.SharingConfig(strategy, clients), **kw)


def _tree(root, prefix, chips, control=()):
    root.mkdir(parents=True, exist_ok=True)
    for i in chips:
        (root / f"{prefix}{i}").touch()
    for name in control:
        (root / name).touch()
    return str(root)


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


class Served:
    """A manager's serve loop on its own plugin dir, a kubelet stub, and a
    DevicePlugin client on the plugin's socket."""

    def __init__(self, root, m, sock_name):
        self.plugin_dir = str(root / "dp")
        os.makedirs(self.plugin_dir)
        self.m, self.sock_name = m, sock_name
        m.plugin_dir = self.plugin_dir
        m.poll_interval, m.chip_check_interval = 0.02, 0.2
        m.discover()
        self.stub = KubeletStub(self.plugin_dir)
        self.thread = threading.Thread(target=m.serve, daemon=True)
        self.thread.start()
        self.req = self.stub.wait_for_registration()
        self.channel = grpc.insecure_channel(
            f"unix://{os.path.join(self.plugin_dir, sock_name)}")
        grpc.channel_ready_future(self.channel).result(timeout=10)
        self.client = DevicePluginStub(self.channel)

    def close(self):
        self.m.stop()
        self.channel.close()
        self.stub.stop()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def pair(tmp_path, request):
    layout, chips, numa = request.param
    jm = JTPUManager(_config(jconfig, layout),
                     JMockDeviceInfo(_tree(tmp_path / "jdev", "accel", chips),
                                     numa_nodes=numa, generation=MODEL))
    tm = TPUManager(_config(config, layout),
                    MockDeviceInfo(_tree(tmp_path / "tdev", "nvidia", chips,
                                         CONTROL), numa_nodes=numa))
    j = Served(tmp_path / "j", jm, jmanager.PLUGIN_SOCKET)
    t = Served(tmp_path / "t", tm, manager.PLUGIN_SOCKET)
    yield layout, j, t
    j.close()
    t.close()


def _snapshot(resp, rename=False):
    return sorted((_rename(d.ID) if rename else d.ID, d.health,
                   tuple(n.ID for n in d.topology.nodes))
                  for d in resp.devices)


def _allocate(served, ids):
    return served.client.Allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devicesIDs=list(x)) for x in ids]))


def _preferred(ids, must, size, jax=False):
    """A one-container PreferredAllocationRequest; jax=True names the
    devices as the JAX plugin does."""
    name = (lambda d: d.replace("nvidia", "accel")) if jax else str
    return pb.PreferredAllocationRequest(container_requests=[
        pb.ContainerPreferredAllocationRequest(
            available_deviceIDs=[name(d) for d in ids],
            must_include_deviceIDs=[name(d) for d in must],
            allocation_size=size)])


def _code(fn):
    try:
        fn()
    except grpc.RpcError as e:
        return e.code()
    return grpc.StatusCode.OK


NUMA4 = {0: 0, 1: 0, 2: 1, 3: 1}


@pytest.mark.parametrize("pair", [
    ("plain", [0, 1, 2, 3], NUMA4), ("sharing2", [0, 1], None),
    ("subslice2", [0, 1, 2, 3], NUMA4)], indirect=True,
    ids=["plain", "sharing2", "subslice2"])
def test_grpc_plugin_matches_jax(pair):
    layout, j, t = pair
    # Registration: the same request but for the resource and socket.
    assert t.req.resource_name == GPU_RESOURCE_NAME == "nvidia.com/gpu"
    assert j.req.resource_name == "google.com/tpu"
    assert (t.req.version, t.req.options) == (j.req.version, j.req.options)
    assert t.req.endpoint == manager.PLUGIN_SOCKET != j.req.endpoint

    # ListAndWatch: the snapshot, then its resend on a health flip.
    jstream = j.client.ListAndWatch(pb.Empty())
    tstream = t.client.ListAndWatch(pb.Empty())
    first = _snapshot(next(tstream))
    assert first == _snapshot(next(jstream), rename=True)
    assert {h for _, h, _ in first} == {HEALTHY}
    j.m.set_chip_health(1, UNHEALTHY)
    t.m.set_chip_health(1, UNHEALTHY)
    flipped = _snapshot(next(tstream))
    assert flipped == _snapshot(next(jstream), rename=True)
    assert any(h == UNHEALTHY for _, h, _ in flipped)

    # Allocate every advertised device, one container each, then all
    # the physical devices in one container.
    ids = [d for d, _, _ in first]
    requests = [[d] for d in ids]
    if layout == "plain":
        requests.append(ids)
    got = _allocate(t, requests)
    want = _allocate(j, [[d.replace("nvidia", "accel") for d in r]
                         for r in requests])
    for tc, jc in zip(got.container_responses, want.container_responses):
        # JAX's card nodes, then (by design) the control nodes present,
        # once per container.
        assert [(os.path.basename(d.host_path), d.permissions)
                for d in tc.devices] == [
            (_rename(os.path.basename(d.host_path)), d.permissions)
            for d in jc.devices] + [(name, "mrw") for name in CONTROL]
        assert all(d.container_path == d.host_path for d in tc.devices)
        # By design: the driver tree, not libtpu.
        assert [(m.container_path, m.host_path, m.read_only)
                for m in tc.mounts] == [("/usr/local/nvidia",
                                         "/home/kubernetes/bin/nvidia", True)]
        assert [m.read_only for m in jc.mounts] == [True]
        # The envs, key by key.
        indices = [int(i) for i in jc.envs["TPU_VISIBLE_CHIPS"].split(",")]
        assert set(jc.envs) == {"TPU_VISIBLE_CHIPS", "TPU_VISIBLE_DEVICES",
                                "TPU_CHIP_GENERATION", "TPU_SKIP_MDS_QUERY"}
        assert set(tc.envs) == {"CUDA_VISIBLE_DEVICES", "GPU_CHIP_GENERATION"}
        # TPU_VISIBLE_CHIPS and TPU_VISIBLE_DEVICES -> the same cards, by
        # UUID, in the same order.
        assert jc.envs["TPU_VISIBLE_DEVICES"] == jc.envs["TPU_VISIBLE_CHIPS"]
        assert tc.envs["CUDA_VISIBLE_DEVICES"] == ",".join(
            mock_uuid(i) for i in indices)
        # TPU_CHIP_GENERATION -> GPU_CHIP_GENERATION.
        assert tc.envs["GPU_CHIP_GENERATION"] \
            == jc.envs["TPU_CHIP_GENERATION"] == MODEL
        # TPU_SKIP_MDS_QUERY has no card meaning.
        assert jc.envs["TPU_SKIP_MDS_QUERY"] == "true"

    # Unknown IDs and requests the sharing rules refuse.
    bad = [["nvidia9"], ["nvidia0/vtpu0", "nvidia0/vtpu1"], ["nvidia0"],
           ["nvidia0/vtpu5"], ["tpu-sub9-2"]]
    for req in bad:
        tcode = _code(lambda: _allocate(t, [req]))
        jcode = _code(lambda: _allocate(
            j, [[d.replace("nvidia", "accel") for d in req]]))
        assert tcode == jcode, req
    assert _code(lambda: _allocate(t, [["nvidia9"]])) \
        == grpc.StatusCode.INVALID_ARGUMENT

    # GetPreferredAllocation: the same choices.
    for size in range(1, len(ids) + 1):
        for must in ([], ids[-1:]):
            tgot = t.client.GetPreferredAllocation(
                _preferred(ids[::-1], must, size))
            jgot = j.client.GetPreferredAllocation(
                _preferred(ids[::-1], must, size, jax=True))
            assert [list(r.deviceIDs) for r in tgot.container_responses] == [
                [_rename(d) for d in r.deviceIDs]
                for r in jgot.container_responses]
    assert t.client.GetDevicePluginOptions(pb.Empty()) \
        == j.client.GetDevicePluginOptions(pb.Empty())
    assert t.client.PreStartContainer(pb.PreStartContainerRequest(
        devicesIDs=ids[:1])) == pb.PreStartContainerResponse()


@pytest.mark.parametrize("numa", [NUMA4, {0: 1, 1: 0, 2: 1, 3: 0},
                                  {2: 0}, None])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_preferred_allocation_matches_jax(tmp_path, numa, layout):
    chips = [0, 1, 2, 3]
    jm = JTPUManager(JTPUConfig(
        chips_per_partition=LAYOUTS[layout].get("chips_per_partition", 0),
        sharing=JSharingConfig(*LAYOUTS[layout].get("sharing", ("", 0)))),
        JMockDeviceInfo(_tree(tmp_path / "j", "accel", chips),
                        numa_nodes=numa))
    tm = TPUManager(TPUConfig(
        chips_per_partition=LAYOUTS[layout].get("chips_per_partition", 0),
        sharing=SharingConfig(*LAYOUTS[layout].get("sharing", ("", 0)))),
        MockDeviceInfo(_tree(tmp_path / "t", "nvidia", chips),
                       numa_nodes=numa))
    jm.discover()
    tm.discover()
    jsvc, tsvc = JDevicePluginService(jm), DevicePluginService(tm)
    ids = sorted(tm.devices) + ["nvidia7"]
    for size in range(1, len(ids) + 1):
        for must in ([], ids[-2:-1], ids[:1]):
            got = tsvc.GetPreferredAllocation(
                _preferred(ids[::-1], must, size), None)
            want = jsvc.GetPreferredAllocation(
                _preferred(ids[::-1], must, size, jax=True), None)
            assert [list(r.deviceIDs) for r in got.container_responses] == [
                [_rename(d) for d in r.deviceIDs]
                for r in want.container_responses]


def _restart_triggers(root, m, sock_name, prefix):
    """Drive the three restart triggers; the registrations seen."""
    served = Served(root, m, sock_name)
    seen = []
    try:
        before = m.restarts
        # 1. The plugin socket is removed: the server restarts.
        os.unlink(os.path.join(served.plugin_dir, sock_name))
        seen.append(served.stub.wait_for_registration().resource_name)
        _wait(lambda: os.path.exists(os.path.join(served.plugin_dir,
                                                  sock_name)), "the socket")
        # 2. The kubelet restarts: a new kubelet.sock.
        served.stub.stop()
        served.stub = KubeletStub(served.plugin_dir)
        seen.append(served.stub.wait_for_registration().resource_name)
        # 3. A card appears: the advertised set changes.
        open(os.path.join(m.device_info.dev_root, f"{prefix}4"), "w").close()
        seen.append(served.stub.wait_for_registration().resource_name)
        _wait(lambda: len(m.devices) == 5, "the new card")
        seen.append(m.restarts - before)
    finally:
        served.close()
    return seen, sorted(m.devices)


def test_restart_triggers_reregister_as_jax_does(tmp_path):
    chips = [0, 1, 2, 3]
    jm = JTPUManager(JTPUConfig(),
                     JMockDeviceInfo(_tree(tmp_path / "jdev", "accel", chips)))
    tm = TPUManager(TPUConfig(),
                    MockDeviceInfo(_tree(tmp_path / "tdev", "nvidia", chips)))
    jseen, jdevs = _restart_triggers(tmp_path / "j", jm,
                                     jmanager.PLUGIN_SOCKET, "accel")
    tseen, tdevs = _restart_triggers(tmp_path / "t", tm,
                                     manager.PLUGIN_SOCKET, "nvidia")
    assert tseen[:3] == ["nvidia.com/gpu"] * 3
    assert jseen[:3] == ["google.com/tpu"] * 3
    assert tseen[3] >= 3 and jseen[3] >= 3
    assert tdevs == [_rename(d) for d in jdevs]
    # The port removes its socket when the loop ends.
    assert not os.path.exists(os.path.join(tmp_path / "t" / "dp",
                                           manager.PLUGIN_SOCKET))


def test_both_packages_pb2_import_in_one_process():
    from container_engine_accelerators_tpu.metrics import (
        podresources_pb2 as jpr,
    )
    from container_engine_accelerators_tpu_torch.metrics import (
        podresources_pb2 as pr,
    )
    assert pb.Device is jpb.Device and pr.PodResources is jpr.PodResources
    # And in the other order, in a fresh process.
    code = "\n".join([
        "from container_engine_accelerators_tpu_torch.deviceplugin.api "
        "import deviceplugin_pb2 as a",
        "from container_engine_accelerators_tpu_torch.metrics import "
        "podresources_pb2 as c",
        "from container_engine_accelerators_tpu.deviceplugin.api import "
        "deviceplugin_pb2 as b",
        "from container_engine_accelerators_tpu.metrics import "
        "podresources_pb2 as d",
        "assert a.AllocateResponse is b.AllocateResponse",
        "assert c.ListPodResourcesResponse is d.ListPodResourcesResponse",
        "print('ok')"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


class RecordingKubelet(RegistrationServicer):
    def __init__(self):
        self.requests = []

    def Register(self, request, context):
        self.requests.append(request)
        return pb.Empty()


def test_device_plugin_main_starts_serves_and_stops_on_sigterm(tmp_path):
    from concurrent import futures
    dev = _tree(tmp_path / "dev", "nvidia", [0, 1], CONTROL)
    plugin_dir = tmp_path / "dp"
    plugin_dir.mkdir()
    kubelet = RecordingKubelet()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    add_registration_servicer(kubelet, server)
    server.add_insecure_port(f"unix://{plugin_dir / 'kubelet.sock'}")
    server.start()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cli.device_plugin_main",
         "--dev-root", dev, "--device-plugin-path", str(plugin_dir),
         "--config-file", str(tmp_path / "absent.json")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sock = plugin_dir / manager.PLUGIN_SOCKET
    try:
        _wait(lambda: kubelet.requests or proc.poll() is not None,
              "registration", timeout=60)
        assert proc.poll() is None
        assert kubelet.requests[0].resource_name == "nvidia.com/gpu"
        channel = grpc.insecure_channel(f"unix://{sock}")
        grpc.channel_ready_future(channel).result(timeout=10)
        first = next(DevicePluginStub(channel).ListAndWatch(pb.Empty()))
        assert sorted(d.ID for d in first.devices) == ["nvidia0", "nvidia1"]
        channel.close()
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
        assert time.monotonic() - t0 < 10
        assert not sock.exists()
        assert "stopped after" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        server.stop(0)


def test_mock_uuid_and_devutil_chip_equality_ignore_the_uuid():
    a = devutil.Chip(0, "/dev/nvidia0", None, None, uuid="GPU-a")
    assert a == devutil.Chip(0, "/dev/nvidia0", None, None)
    assert mock_uuid(3).startswith("GPU-00000003-")


def test_envs_refuse_a_card_without_a_uuid(tmp_path, monkeypatch):
    from container_engine_accelerators_tpu_torch.utils import nvml
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    (tmp_path / "nvidia0").touch()
    info = devutil.SysfsDeviceInfo(dev_root=str(tmp_path),
                                   proc_gpus_root=str(tmp_path / "absent"))
    m = TPUManager(TPUConfig(), info)
    m.discover()
    with pytest.raises(ValueError, match="no UUID"):
        m.envs(["nvidia0"])
