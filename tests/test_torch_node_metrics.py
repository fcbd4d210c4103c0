"""The port's card metrics against the JAX package's: the NVML binding
and NvmlSampler over a fake function table, devutil's NVML path, the
torch-ordinal -> minor mapping, MetricServer fed the same samples and
PodResources answers as JAX's (same families, label sets and values;
`tpu_chip` accel<N> -> nvidia<N>), and the driver-version annotations.
Differences by design: the resource name (`nvidia.com/gpu`) and the
annotation prefix (`cloud.google.com/cuda.driver-version`)."""

import ctypes
import os
import time
import types
import urllib.request

import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.deviceplugin import (
    MockDeviceInfo as JMockDeviceInfo,
    TPUConfig as JTPUConfig,
    TPUManager as JTPUManager,
)
from container_engine_accelerators_tpu.deviceplugin import (
    version_visibility as jvv,
)
from container_engine_accelerators_tpu.metrics import (
    ChipSample as JChipSample,
    FakeSampler as JFakeSampler,
    MetricServer as JMetricServer,
)
from container_engine_accelerators_tpu.metrics import (
    PodResourcesClient as JPodResourcesClient,
)
from container_engine_accelerators_tpu_torch import GPU_RESOURCE_NAME
from container_engine_accelerators_tpu_torch.deviceplugin import (
    MockDeviceInfo,
    TPUConfig,
    TPUManager,
    devutil,
    version_visibility as vv,
)
from container_engine_accelerators_tpu_torch.healthcheck import (
    TPUHealthChecker,
)
from container_engine_accelerators_tpu_torch.metrics import (
    podresources_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.metrics import sampler as smp
from container_engine_accelerators_tpu_torch.metrics.devices import (
    PodResourcesClient,
)
from container_engine_accelerators_tpu_torch.metrics.metrics import (
    MetricServer,
)
from container_engine_accelerators_tpu_torch.utils import nvml
from tests.test_metrics import PodResourcesStubServer

MODEL = "NVIDIA H100 80GB HBM3"
ERROR_TEXT = {3: b"Not Supported", 6: b"Not Found", 15: b"GPU is lost",
              999: b"Unknown Error"}


class FakeCard:
    """One card of FakeNvmlTable; `util` may be a callable giving the
    (gpu, memory) percentages at each call."""

    def __init__(self, minor, uuid=None, name=MODEL, bus_id=None,
                 total=80 << 30, used=1 << 30, util=(0, 0), samples=(),
                 capacity=72, samples_rc=0, memory_rc=0):
        self.minor = minor
        self.uuid = uuid or f"GPU-{minor:08x}-1111-4222-8333-444444444444"
        self.name, self.bus_id = name, bus_id
        self.total, self.used, self.util = total, used, util
        self.samples = list(samples)      # (timestamp us, percent)
        self.capacity, self.samples_rc = capacity, samples_rc
        self.memory_rc = memory_rc


class FakeNvmlTable:
    """NVML's calls as Python callables that fill the ctypes arguments
    the binding passes, as the library would. `fail` maps a call's name
    to the code it returns."""

    def __init__(self, cards, driver="580.159.03", fail=None):
        self.cards = list(cards)
        self.driver = driver
        self.fail = dict(fail or {})
        self.calls: list[str] = []

    def __getattribute__(self, name):
        attr = object.__getattribute__(self, name)
        if name.startswith("nvml") and name != "nvmlErrorString":
            fail = object.__getattribute__(self, "fail")
            calls = object.__getattribute__(self, "calls")

            def call(*args):
                calls.append(name)
                return fail[name] if name in fail else attr(*args)
            return call
        return attr

    def _card(self, handle):
        return self.cards[handle.value - 1000]

    def nvmlErrorString(self, rc):
        return ERROR_TEXT.get(rc, b"Unknown Error")

    def nvmlInit_v2(self):
        return 0

    def nvmlShutdown(self):
        return 0

    def nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = self.driver.encode()
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.cards)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle._obj.value = 1000 + index
        return 0

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self._card(handle).minor
        return 0

    def nvmlDeviceGetPciInfo_v3(self, handle, info):
        card = self._card(handle)
        if card.bus_id is None:
            return 3
        info._obj.busId = card.bus_id.encode()
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, size):
        buf.value = self._card(handle).uuid.encode()
        return 0

    def nvmlDeviceGetName(self, handle, buf, size):
        buf.value = self._card(handle).name.encode()
        return 0

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        card = self._card(handle)
        if card.memory_rc:
            return card.memory_rc
        mem._obj.total, mem._obj.used = card.total, card.used
        mem._obj.free = card.total - card.used
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        rates = self._card(handle).util
        util._obj.gpu, util._obj.memory = rates() if callable(rates) \
            else rates
        return 0

    def nvmlDeviceGetSamples(self, handle, kind, last_seen, value_type,
                             count, samples):
        card = self._card(handle)
        assert kind == nvml.GPU_UTILIZATION_SAMPLES
        if card.samples_rc:
            return card.samples_rc
        value_type._obj.value = 1          # NVML_VALUE_TYPE_UNSIGNED_INT
        if samples is None:                # the buffer's size, not a count
            count._obj.value = card.capacity
            return 0
        newer = [s for s in card.samples if s[0] > last_seen]
        if not newer:
            return 6
        assert count._obj.value >= len(newer)
        for i, (ts, value) in enumerate(newer):
            samples[i].timeStamp = ts
            samples[i].sampleValue.uiVal = value
        count._obj.value = len(newer)
        return 0


# ---------------------------------------------------------------- binding

def test_binding_reads_what_the_table_gives_and_raises_its_text():
    cards = [FakeCard(7, bus_id="00000000:DB:00.0"), FakeCard(3)]
    table = FakeNvmlTable(cards)
    with nvml.Nvml(table) as session:
        assert session.driver_version() == "580.159.03"
        assert session.device_count() == 2
        got = session.cards()
        assert got == {
            7: nvml.CardIdentity(0, 7, "0000:db:00.0", cards[0].uuid, MODEL),
            3: nvml.CardIdentity(1, 3, None, cards[1].uuid, MODEL)}
        h = session.handle_by_minor(3)
        assert session.memory_info(h) == (80 << 30, 79 << 30, 1 << 30)
        with pytest.raises(nvml.NvmlError, match="Not Found") as err:
            session.handle_by_minor(5)
        assert err.value.code == nvml.ERROR_NOT_FOUND
        table.fail["nvmlDeviceGetMemoryInfo"] = 15
        with pytest.raises(nvml.NvmlError,
                           match="nvmlDeviceGetMemoryInfo: GPU is lost") as err:
            session.memory_info(h)
        assert err.value.code == 15 and err.value.text == "GPU is lost"
    assert table.calls[0] == "nvmlInit_v2" and table.calls[-1] == "nvmlShutdown"
    with pytest.raises(nvml.NvmlError, match="nvmlInit_v2: Unknown Error"):
        nvml.Nvml(FakeNvmlTable([], fail={"nvmlInit_v2": 999}))


def test_binding_declares_every_call_and_the_struct_layouts():
    assert ctypes.sizeof(nvml.PciInfo) == 68
    assert ctypes.sizeof(nvml.Memory) == 24
    assert ctypes.sizeof(nvml.Sample) == 16
    assert nvml.sysfs_pci_address("00000000:18:00.0") == "0000:18:00.0"
    assert set(nvml.SIGNATURES) == {
        "nvmlInit_v2", "nvmlShutdown", "nvmlSystemGetDriverVersion",
        "nvmlDeviceGetCount_v2", "nvmlDeviceGetHandleByIndex_v2",
        "nvmlDeviceGetMinorNumber", "nvmlDeviceGetPciInfo_v3",
        "nvmlDeviceGetUUID", "nvmlDeviceGetName", "nvmlDeviceGetMemoryInfo",
        "nvmlDeviceGetSamples", "nvmlDeviceGetUtilizationRates",
        "nvmlDeviceGetNvLinkState", "nvmlDeviceGetNvLinkErrorCounter"}


def _no_library(monkeypatch):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")


def test_make_sampler_raises_nvmls_error_where_the_library_is_absent(
        monkeypatch):
    _no_library(monkeypatch)
    with pytest.raises(nvml.NvmlError,
                       match="NVML Shared Library Not Found") as err:
        smp.make_sampler()
    assert err.value.code == nvml.ERROR_LIBRARY_NOT_FOUND
    with pytest.raises(nvml.NvmlError, match="no card"):
        smp.make_sampler(nvml.Nvml(FakeNvmlTable([])))
    assert isinstance(smp.make_sampler(nvml.Nvml(FakeNvmlTable(
        [FakeCard(0)]))), smp.NvmlSampler)


# ---------------------------------------------------------------- sampler

def test_sampler_averages_the_samples_newer_than_the_last_call():
    card = FakeCard(7, samples=[(10, 50), (20, 70)], util=(33, 5),
                    used=8 << 30)
    table = FakeNvmlTable([FakeCard(3), card])
    sampler = smp.NvmlSampler(nvml.Nvml(table))
    first = sampler.sample(7)
    assert first == smp.ChipSample(60.0, 8 << 30, 80 << 30)
    assert sampler.last_source[7] == smp.SAMPLES
    card.samples += [(30, 90), (40, 100)]
    assert sampler.sample(7).duty_cycle_pct == 95.0    # only the new two
    # Nothing newer: NVML's utilisation over its last period.
    assert sampler.sample(7).duty_cycle_pct == 33.0
    assert sampler.last_source[7] == smp.UTILIZATION_RATES
    card.samples.append((50, 10))
    assert sampler.sample(7).duty_cycle_pct == 10.0
    assert sampler.sample(5) is None                   # no such minor


def test_sampler_takes_utilization_rates_where_the_buffer_is_not_supported():
    card = FakeCard(0, samples=[(10, 50)], util=(99, 30), samples_rc=3)
    table = FakeNvmlTable([card])
    sampler = smp.NvmlSampler(nvml.Nvml(table))
    assert sampler.sample(0).duty_cycle_pct == 99.0
    assert sampler.sample(0).duty_cycle_pct == 99.0
    assert sampler.last_source[0] == smp.UTILIZATION_RATES
    # The buffer is asked once; its refusal is remembered.
    assert table.calls.count("nvmlDeviceGetSamples") == 1


@pytest.mark.parametrize("call,code", [
    ("nvmlDeviceGetSamples", 15), ("nvmlDeviceGetMemoryInfo", 15),
    ("nvmlDeviceGetUtilizationRates", 999), ("nvmlDeviceGetCount_v2", 999)])
def test_sampler_raises_every_other_refusal(call, code):
    card = FakeCard(0, util=(10, 0))            # no samples: rates asked
    sampler = smp.NvmlSampler(nvml.Nvml(FakeNvmlTable([card],
                                                      fail={call: code})))
    with pytest.raises(nvml.NvmlError, match=call):
        sampler.sample(0)


# ---------------------------------------------------------------- devutil

def test_devutil_takes_card_metadata_from_nvml_without_proc(tmp_path):
    dev, pci = tmp_path / "dev", tmp_path / "pci"
    dev.mkdir()
    for name in ("nvidia0", "nvidia7", "nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    (pci / "0000:db:00.0").mkdir(parents=True)
    (pci / "0000:db:00.0" / "numa_node").write_text("1\n")
    card = FakeCard(7, bus_id="00000000:DB:00.0")
    info = devutil.SysfsDeviceInfo(
        dev_root=str(dev), proc_gpus_root=str(tmp_path / "absent"),
        sysfs_pci_root=str(pci), nvml=nvml.Nvml(FakeNvmlTable([card])))
    chips = info.discover()
    assert [(c.index, c.pci_address, c.numa_node, c.uuid) for c in chips] == [
        (0, None, None, None), (7, "0000:db:00.0", 1, card.uuid)]
    assert info.chip_generation() == MODEL
    # A card NVML names without a PCI address keeps its UUID and model.
    info = devutil.SysfsDeviceInfo(
        dev_root=str(dev), proc_gpus_root=str(tmp_path / "absent"),
        nvml=nvml.Nvml(FakeNvmlTable([FakeCard(7, name="NVIDIA X")])))
    assert [(c.index, c.pci_address, c.uuid is not None)
            for c in info.discover()] == [(0, None, False), (7, None, True)]
    assert info.chip_generation() == "NVIDIA X"


def test_devutil_without_nvml_has_no_metadata(tmp_path, monkeypatch,
                                              caplog):
    _no_library(monkeypatch)
    (tmp_path / "nvidia0").touch()
    info = devutil.SysfsDeviceInfo(dev_root=str(tmp_path),
                                   proc_gpus_root=str(tmp_path / "absent"))
    assert [(c.index, c.uuid) for c in info.discover()] == [(0, None)]
    assert info.chip_generation() == "unknown"
    assert info.nvml() is None
    # NVML is tried once, and its error logged once.
    assert caplog.text.count("NVML Shared Library Not Found") == 1


def _fake_torch(uuid, bus, domain=0, device=0):
    props = types.SimpleNamespace(uuid=uuid, pci_bus_id=bus,
                                  pci_domain_id=domain, pci_device_id=device)
    return types.SimpleNamespace(cuda=types.SimpleNamespace(
        get_device_properties=lambda ordinal: props))


def test_torch_ordinal_maps_to_the_minor_by_uuid_then_pci():
    cards = nvml.Nvml(FakeNvmlTable([
        FakeCard(7, uuid="GPU-8b6ea3a9-3970-f056-d6e0-96d726a1740f"),
        FakeCard(3, bus_id="00000000:18:00.0")])).cards()
    assert devutil.torch_card_minor(
        _fake_torch("8b6ea3a9-3970-f056-d6e0-96d726a1740f", 219),
        0, cards) == 7
    assert devutil.torch_card_minor(_fake_torch("0000", 0x18), 0, cards) == 3
    assert devutil.torch_card_minor(_fake_torch("0000", 0x19), 0,
                                    cards) is None


# ---------------------------------------------------------------- MetricServer

def _response(resource, ids, pods=(("train-0", "ml", "main"),)):
    return pb.ListPodResourcesResponse(pod_resources=[
        pb.PodResources(name=pod, namespace=ns, containers=[
            pb.ContainerResources(name=ctr, devices=[
                pb.ContainerDevices(resource_name=resource,
                                    device_ids=list(ids)),
                pb.ContainerDevices(resource_name="other.com/thing",
                                    device_ids=["x"])])])
        for pod, ns, ctr in pods] + [
        pb.PodResources(name="idle", namespace="ml",
                        containers=[pb.ContainerResources(name="c")])])


def _families(registry, rename=False) -> set:
    out = set()
    for family in registry.collect():
        for s in family.samples:
            labels = dict(s.labels)
            if rename and "tpu_chip" in labels:
                labels["tpu_chip"] = labels["tpu_chip"].replace(
                    "accel", "nvidia")
            out.add((s.name, tuple(sorted(labels.items())), s.value))
    return out


class _Pair:
    """A JAX and a port MetricServer over the same cards, samples and
    PodResources answers."""

    def __init__(self, tmp_path, chips, samples, ids, pods=None):
        jdev, tdev = tmp_path / "j", tmp_path / "t"
        jdev.mkdir()
        tdev.mkdir()
        for i in chips:
            (jdev / f"accel{i}").touch()
            (tdev / f"nvidia{i}").touch()
        self.jdev, self.tdev = str(jdev), str(tdev)
        self.jm = JTPUManager(JTPUConfig(),
                              JMockDeviceInfo(self.jdev, generation=MODEL))
        self.tm = TPUManager(TPUConfig(), MockDeviceInfo(self.tdev))
        self.jm.discover()
        self.tm.discover()
        pods = pods or (("train-0", "ml", "main"),)
        self.jsrv = PodResourcesStubServer(
            str(tmp_path / "j.sock"),
            _response("google.com/tpu", [f"accel{i}" for i in ids], pods))
        self.tsrv = PodResourcesStubServer(
            str(tmp_path / "t.sock"),
            _response(GPU_RESOURCE_NAME, [f"nvidia{i}" for i in ids], pods))
        self.j = JMetricServer(
            self.jm, sampler=JFakeSampler({
                c: JChipSample(*s) for c, s in samples.items()}),
            pod_resources=JPodResourcesClient(str(tmp_path / "j.sock")))
        self.t = MetricServer(
            self.tm, sampler=smp.FakeSampler({
                c: smp.ChipSample(*s) for c, s in samples.items()}),
            pod_resources=PodResourcesClient(str(tmp_path / "t.sock")))

    def update(self):
        self.j.update_once()
        self.t.update_once()
        got, want = _families(self.t.registry), _families(self.j.registry,
                                                          rename=True)
        assert got == want
        return got

    def stop(self):
        self.jsrv.stop()
        self.tsrv.stop()


@pytest.mark.parametrize("chips,ids", [([0, 1], [1]), ([0, 1], [0, 1]),
                                       ([0, 2, 3], [2, 9]), ([0], [])])
def test_metric_server_matches_jax(tmp_path, chips, ids):
    samples = {0: (10.0, 1 << 30, 16 << 30), 1: (85.5, 8 << 30, 16 << 30),
               2: (40.25, 3, 16 << 30), 3: (0.0, 0, 16 << 30)}
    pair = _Pair(tmp_path, chips, samples, ids)
    try:
        got = pair.update()
    finally:
        pair.stop()
    names = {name for name, _, _ in got}
    assert {"node_duty_cycle", "node_memory_used", "node_memory_total",
            "tpu_chip_memory_used_bytes",
            "tpu_chip_memory_total_bytes"} <= names
    if ids:
        assert ("request_tpu_chips", (("container", "main"), ("namespace",
                "ml"), ("pod", "train-0")), float(len(ids))) in got
        assert ("duty_cycle", (("container", "main"), ("model", MODEL),
                ("namespace", "ml"), ("pod", "train-0"),
                ("tpu_chip", f"nvidia{ids[0]}")),
                samples[ids[0]][0]) in got


def test_metric_server_clears_stale_containers_and_vanished_cards(tmp_path):
    samples = {0: (10.0, 1, 2), 1: (20.0, 3, 4)}
    pair = _Pair(tmp_path, [0, 1], samples, [0, 1],
                 pods=(("gone", "ml", "c"), ("p", "ml", "c")))
    try:
        assert any('gone' in str(labels) for _, labels, _ in pair.update())
        # The pod exits; card 1 disappears.
        pair.jsrv.response = _response("google.com/tpu", ["accel0"])
        pair.tsrv.response = _response(GPU_RESOURCE_NAME, ["nvidia0"])
        os.unlink(os.path.join(pair.jdev, "accel1"))
        os.unlink(os.path.join(pair.tdev, "nvidia1"))
        pair.jm.discover()
        pair.tm.discover()
        got = pair.update()
        assert not any("gone" in str(labels) or "nvidia1" in str(labels)
                       for _, labels, _ in got)
    finally:
        pair.stop()


def test_metric_server_drops_a_card_nvml_refuses_and_refreshes_the_rest(
        tmp_path, caplog):
    # NVML refuses one of two cards (GPU_IS_LOST): that card's gauges are
    # cleared, not served stale, and the other card's are refreshed.
    for i in (0, 1):
        (tmp_path / f"nvidia{i}").touch()
    m = TPUManager(TPUConfig(), MockDeviceInfo(str(tmp_path)))
    m.discover()
    srv = PodResourcesStubServer(str(tmp_path / "pr.sock"), _response(
        GPU_RESOURCE_NAME, ["nvidia0", "nvidia1"]))
    cards = [FakeCard(0, util=(10, 0), used=1 << 30),
             FakeCard(1, util=(20, 0), used=2 << 30)]
    ms = MetricServer(m, sampler=smp.make_sampler(nvml.Nvml(
        FakeNvmlTable(cards))), pod_resources=PodResourcesClient(
            str(tmp_path / "pr.sock")))

    def gauges(name):
        return {s.labels["tpu_chip"]: s.value for f in ms.registry.collect()
                for s in f.samples if s.name == name}
    try:
        ms.update_once()
        assert gauges("node_duty_cycle") == {"nvidia0": 10.0,
                                             "nvidia1": 20.0}
        cards[1].memory_rc = 15
        cards[0].util, cards[0].used = (70, 0), 9 << 30
        ms.update_once()
        for name in ("node_duty_cycle", "duty_cycle"):
            assert gauges(name) == {"nvidia0": 70.0}
        for name in ("node_memory_used", "tpu_chip_memory_used_bytes",
                     "memory_used"):
            assert gauges(name) == {"nvidia0": float(9 << 30)}
        assert "card 1 not sampled: nvmlDeviceGetMemoryInfo: GPU is lost" \
            in caplog.text
        # The card answers again: it is back on the next cycle.
        cards[1].memory_rc = 0
        ms.update_once()
        assert gauges("node_duty_cycle") == {"nvidia0": 70.0,
                                             "nvidia1": 20.0}
    finally:
        srv.stop()


def test_metric_server_without_podresources_serves_the_cards(tmp_path):
    # PodResources down: the node gauges stay, the container ones go, in
    # both packages.
    pair = _Pair(tmp_path, [0, 1], {0: (10.0, 1, 2), 1: (20.0, 3, 4)}, [1])
    try:
        pair.update()
        pair.jsrv.stop()
        pair.tsrv.stop()
        got = pair.update()
    finally:
        pair.stop()
    assert {name for name, _, _ in got} >= {"node_duty_cycle"}
    assert not any(name in ("duty_cycle", "request_tpu_chips")
                   for name, _, _ in got)


def test_metric_server_serves_the_health_counters_over_http(tmp_path):
    (tmp_path / "nvidia0").touch()
    m = TPUManager(TPUConfig(), MockDeviceInfo(str(tmp_path)))
    m.discover()
    srv = PodResourcesStubServer(str(tmp_path / "pr.sock"),
                                 _response(GPU_RESOURCE_NAME, ["nvidia0"]))
    table = FakeNvmlTable([FakeCard(0, util=(64, 0), used=5 << 30)])
    ms = MetricServer(m, sampler=smp.make_sampler(nvml.Nvml(table)),
                      pod_resources=PodResourcesClient(
                          str(tmp_path / "pr.sock")),
                      port=0, interval=0.05)
    checker = TPUHealthChecker(m, TPUConfig(), sources=[],
                               registry=ms.registry)
    checker.handle_event(types.SimpleNamespace(
        chip_index=0, error_class="HBM_ECC_UNCORRECTABLE", message="x"))
    ms.start_background()
    try:
        # The poll thread refills the gauges every 0.05 s; a scrape may
        # land between a clear and the refill, so take the first whole
        # one.
        deadline = time.monotonic() + 10
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ms.bound_port}/metrics",
                    timeout=10) as resp:
                text = resp.read().decode()
            if "request_tpu_chips{" in text or time.monotonic() > deadline:
                break
            time.sleep(0.01)
    finally:
        ms.stop()
        srv.stop()
    assert f'node_duty_cycle{{model="{MODEL}",tpu_chip="nvidia0"}} 64.0' \
        in text
    assert 'tpu_health_events_total{error_class="HBM_ECC_UNCORRECTABLE"} 1.0' \
        in text
    assert "tpu_health_last_event_timestamp" in text
    assert 'request_tpu_chips{container="main",namespace="ml",' \
           'pod="train-0"} 1.0' in text
    assert all(not t.is_alive() for t in ms._threads)


def test_podresources_service_is_the_jax_packages(tmp_path):
    # One message set, one wire format: the JAX package's stub server
    # answers the port's client.
    srv = PodResourcesStubServer(str(tmp_path / "pr.sock"), _response(
        GPU_RESOURCE_NAME, ["nvidia0", "nvidia1"]))
    try:
        out = PodResourcesClient(str(tmp_path / "pr.sock")) \
            .containers_with_devices()
    finally:
        srv.stop()
    assert [(c.namespace, c.pod, c.container, c.device_ids) for c in out] \
        == [("ml", "train-0", "main", ("nvidia0", "nvidia1"))]


# ---------------------------------------------------------------- versions

@pytest.mark.parametrize("version", ["580.159.03", "535.104", "1.2.3rc1",
                                     "v5", ""])
def test_version_annotations_have_jaxs_keys_under_the_cuda_prefix(version):
    got = vv.version_annotations(version)
    want = jvv.version_annotations(version)
    assert {k.replace(vv.ANNOTATION_PREFIX, jvv.ANNOTATION_PREFIX): v
            for k, v in got.items()} == want
    assert vv.ANNOTATION_PREFIX == "cloud.google.com/cuda.driver-version"


@pytest.mark.parametrize("files,want", [
    ({"version": "580.159.03\n", "libnvidia-ml.so.1.2.3": ""}, "580.159.03"),
    ({"libnvidia-ml.so.580.159.03": "", "libcuda.so.575.57.08": "",
      "libnvidia-ml.so.1": "", "libcuda.so.1": ""}, "580.159.03"),
    ({"libcuda.so.575.57.08": "", "libcuda.so.580.159.03": ""}, "580.159.03"),
    ({"lib64/libnvidia-ml.so.550.90.07": ""}, "550.90.07"),
    ({"libcuda.so.535.104": ""}, "535.104"),
    ({"libcuda.so.1": "", "libcuda.so": ""}, None),
    ({}, None),
])
def test_read_driver_version(tmp_path, files, want):
    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    assert vv.read_driver_version(str(tmp_path)) == want


def test_publish_version_annotations(tmp_path):
    class K8s:
        def __init__(self):
            self.calls = []

        def annotate_node(self, name, annotations):
            self.calls.append((name, annotations))

    (tmp_path / "libnvidia-ml.so.580.159.03").touch()
    k8s = K8s()
    assert vv.publish_version_annotations(k8s, "node-a", str(tmp_path))
    assert k8s.calls == [("node-a", vv.version_annotations("580.159.03"))]
    assert not vv.publish_version_annotations(k8s, "node-a",
                                              str(tmp_path / "absent"))


def test_health_checker_registry_is_shared_not_duplicated(tmp_path):
    # The daemon hands the checker the metric server's registry: the
    # checker must register its two families there, once.
    reg = CollectorRegistry()
    m = TPUManager(TPUConfig(), MockDeviceInfo(str(tmp_path)))
    TPUHealthChecker(m, TPUConfig(), sources=[], registry=reg)
    names = {f.name for f in reg.collect()}
    assert {"tpu_health_events", "tpu_health_last_event_timestamp"} <= names
