"""The port's device plugin (config, discovery, sharing, subslices, the
device manager and its WakeQueue) held against the JAX package's on the
same inputs. The JAX side discovers `/dev/accel<N>`, the port
`/dev/nvidia<N>`: device IDs are compared after renaming accel ->
nvidia."""

import dataclasses
import json
import os
import queue
import stat
import threading

import pytest

from container_engine_accelerators_tpu.deviceplugin import config as jconfig
from container_engine_accelerators_tpu.deviceplugin import devutil as jdevutil
from container_engine_accelerators_tpu.deviceplugin import manager as jmanager
from container_engine_accelerators_tpu.deviceplugin import sharing as jsharing
from container_engine_accelerators_tpu.deviceplugin import (
    subslice as jsubslice,
)
from container_engine_accelerators_tpu.utils import wakeq as jwakeq
from container_engine_accelerators_tpu_torch.deviceplugin import (
    HEALTHY,
    UNHEALTHY,
    config,
    devutil,
    manager,
    sharing,
    subslice,
)
from container_engine_accelerators_tpu_torch.utils import wakeq


def _rename(device_id: str) -> str:
    return device_id.replace("accel", "nvidia")


def _fake_dev(root, prefix, indices):
    """A /dev of `prefix`<N> files for `indices`, plus noise that is not
    a chip on either side."""
    root.mkdir(parents=True, exist_ok=True)
    for i in indices:
        (root / f"{prefix}{i}").touch()
    for noise in ("null", f"{prefix}X", "nvidiactl", "nvidia-uvm"):
        (root / noise).touch()
    return str(root)


def _outcome(fn, *args):
    """("ok", value) or ("error", exception type) of fn(*args)."""
    try:
        return "ok", fn(*args)
    except Exception as e:   # both sides must fail alike
        return "error", type(e)


# ---------------------------------------------------------------- config

CONFIG_CASES = [
    None,
    {},
    {"chipsPerPartition": 2},
    {"chipsPerPartition": -1},
    {"chipsPerPartition": 2,
     "chipSharingConfig": {"strategy": "time-sharing",
                           "maxSharedClientsPerChip": 2}},
    {"chipSharingConfig": {"strategy": "time-sharing",
                           "maxSharedClientsPerChip": 1}},
    {"chipSharingConfig": {"strategy": "mps", "maxSharedClientsPerChip": 4}},
    {"chipSharingConfig": {"strategy": "time-sharing",
                           "maxSharedClientsPerChip": 4}},
    {"healthCriticalErrors": ["CHIP_LOST", "HBM_OOM"]},
    {"healthCriticalErrors": ["NOPE"]},
    {"runtimeLogScraper": {"path": "/var/log/runtime.log", "rules": [
        {"pattern": "melted", "class": "THERMAL_TRIP"}]}},
    {"runtimeLogScraper": {"path": "x", "rules": [
        {"pattern": "(", "class": "THERMAL_TRIP"}]}},
    {"runtimeLogScraper": {"path": "x", "rules": [
        {"pattern": "ok", "class": "NOPE"}]}},
    {"runtimeLogScraper": {"path": "x", "rules": [{"class": "CHIP_LOST"}]}},
]


@pytest.mark.parametrize("env", [None, "CHIP_LOST, HBM_OOM", "NOPE", ",,"])
@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_config_load_accepts_and_refuses_what_jax_does(tmp_path, monkeypatch,
                                                      case, env):
    raw = CONFIG_CASES[case]
    path = tmp_path / "tpu_config.json"
    if raw is not None:
        path.write_text(json.dumps(raw))
    if env is None:
        monkeypatch.delenv("TPU_HEALTH_CONFIG", raising=False)
    else:
        monkeypatch.setenv("TPU_HEALTH_CONFIG", env)
    got = _outcome(config.load, str(path))
    want = _outcome(jconfig.load, str(path))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    else:
        assert got[1] is want[1]


def test_config_classes_are_the_jax_packages():
    assert config.KNOWN_ERROR_CLASSES == jconfig.KNOWN_ERROR_CLASSES
    assert config.DEFAULT_CRITICAL == jconfig.DEFAULT_CRITICAL
    assert config.VALID_STRATEGIES == jconfig.VALID_STRATEGIES


# ---------------------------------------------------------------- sharing

@pytest.mark.parametrize("ids,enabled", [
    ([], False), ([], True), (["x0"], False), (["x0/vtpu1"], False),
    (["x0/vtpu1"], True), (["x0"], True), (["x0/vtpu0", "x0/vtpu1"], True),
])
def test_sharing_requests_match_jax(ids, enabled):
    got = _outcome(sharing.validate_request, ids, enabled)
    want = _outcome(jsharing.validate_request, ids, enabled)
    assert got == want


@pytest.mark.parametrize("device_id", ["nvidia0/vtpu2", "nvidia0", "/vtpu1",
                                       "nvidia1/vtpux"])
def test_virtual_ids_match_jax(device_id):
    assert sharing.is_virtual_id(device_id) == jsharing.is_virtual_id(
        device_id)
    assert (_outcome(sharing.virtual_to_physical, device_id)
            == _outcome(jsharing.virtual_to_physical, device_id))
    assert sharing.virtual_id("nvidia0", 2) == "nvidia0/vtpu2"


@pytest.mark.parametrize("device_id", ["tpu-sub3-2", "tpu-sub3", "tpu-subx-2",
                                       "sub3-2"])
def test_subslice_ids_match_jax(device_id):
    assert (_outcome(subslice.parse_subslice_id, device_id)
            == _outcome(jsubslice.parse_subslice_id, device_id))


# ---------------------------------------------------------------- manager

CHIP_SETS = [[0, 1, 2, 3], [0, 2], [1], [], list(range(8))]
LAYOUTS = {
    "plain": {},
    "sharing2": {"sharing": ("time-sharing", 2)},
    "sharing3": {"sharing": ("time-sharing", 3)},
    "subslice1": {"chips_per_partition": 1},
    "subslice2": {"chips_per_partition": 2},
    "subslice4": {"chips_per_partition": 4},
}


def _config(mod, layout):
    kw = dict(LAYOUTS[layout])
    strategy, clients = kw.pop("sharing", ("", 0))
    return mod.TPUConfig(sharing=mod.SharingConfig(strategy, clients), **kw)


def _managers(tmp_path, chips, layout, numa=None):
    jm = jmanager.TPUManager(
        _config(jconfig, layout),
        jdevutil.MockDeviceInfo(_fake_dev(tmp_path / "jdev", "accel", chips),
                                numa_nodes=numa))
    tm = manager.TPUManager(
        _config(config, layout),
        devutil.MockDeviceInfo(_fake_dev(tmp_path / "tdev", "nvidia", chips),
                               numa_nodes=numa))
    return jm, tm


def _devices(m, rename=False):
    """ID -> (health, NUMA nodes) of the manager's Device messages."""
    return {_rename(d.ID) if rename else d.ID:
            (d.health, [n.ID for n in d.topology.nodes])
            for d in m.snapshot()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chips", CHIP_SETS, ids=lambda c: f"chips{len(c)}")
def test_manager_discovery_and_health_match_jax(tmp_path, chips, layout):
    numa = {i: i // 4 for i in chips}
    jm, tm = _managers(tmp_path, chips, layout, numa)
    got, want = _outcome(tm.discover), _outcome(jm.discover)
    assert got[0] == want[0] and (got[0] == "ok" or got[1] is want[1])
    if got[0] == "error":
        return
    assert tm.check_device_paths() == jm.check_device_paths() == bool(chips)
    assert tm.chip_indices() == jm.chip_indices() == sorted(chips)
    assert _devices(tm) == _devices(jm, rename=True)
    for dev_id in jm.devices:
        assert ([c.index for c in tm.chips_for_device(_rename(dev_id))]
                == [c.index for c in jm.chips_for_device(dev_id)])
    jq, tq = jm.add_listener(), tm.add_listener()
    for idx in [*chips[:2], 99]:
        jm.set_chip_health(idx, UNHEALTHY)
        tm.set_chip_health(idx, UNHEALTHY)
        assert _devices(tm) == _devices(jm, rename=True)
        assert tq.qsize() == jq.qsize()
    # Rediscovery keeps health; a device flip back wakes the listener.
    jm.discover()
    tm.discover()
    assert _devices(tm) == _devices(jm, rename=True)
    for dev_id in list(jm.devices)[:1]:
        jm.set_device_health(dev_id, HEALTHY)
        tm.set_device_health(_rename(dev_id), HEALTHY)
    assert _devices(tm) == _devices(jm, rename=True)
    assert tq.qsize() == jq.qsize()
    tm.remove_listener(tq)
    jm.remove_listener(jq)
    with pytest.raises(KeyError):
        tm.chips_for_device("nvidia99")


def test_manager_snapshot_is_a_copy(tmp_path):
    _, tm = _managers(tmp_path, [0, 1], "plain")
    tm.discover()
    snap = tm.snapshot()
    snap[0].health = UNHEALTHY
    assert {d.health for d in tm.snapshot()} == {HEALTHY}
    tm.stop()
    assert tm.stopped


# ---------------------------------------------------------------- discovery

def _fake_nvidia_tree(root, cards):
    """/dev, /proc/driver/nvidia/gpus and /sys/bus/pci/devices for
    `cards` {minor: (pci, numa, model)}."""
    dev = root / "dev"
    dev.mkdir()
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset", "nvidiaX", "null"):
        (dev / name).touch()
    (dev / "nvidia-caps").mkdir()
    (dev / "nvidia7").mkdir()    # a directory, not a card
    gpus, pci_root = root / "gpus", root / "pci"
    for minor, (pci, numa, model) in cards.items():
        (dev / f"nvidia{minor}").touch()
        (gpus / pci).mkdir(parents=True)
        (gpus / pci / "information").write_text(
            f"Model: \t\t {model}\nIRQ:   \t\t 42\n"
            f"GPU UUID: \t GPU-{minor:08x}\nBus Location: \t {pci}\n"
            f"Device Minor: \t {minor}\nGPU Excluded:\t No\n")
        (pci_root / pci).mkdir(parents=True)
        (pci_root / pci / "numa_node").write_text(f"{numa}\n")
    return str(dev), str(gpus), str(pci_root)


def test_sysfs_discovery_on_a_fake_nvidia_tree(tmp_path):
    dev, gpus, pci = _fake_nvidia_tree(tmp_path, {
        0: ("0000:18:00.0", 0, "NVIDIA H100 80GB HBM3"),
        3: ("0000:9a:00.0", -1, "NVIDIA H100 80GB HBM3"),
    })
    info = devutil.SysfsDeviceInfo(dev_root=dev, proc_gpus_root=gpus,
                                   sysfs_pci_root=pci)
    assert info.discover() == [
        devutil.Chip(0, os.path.join(dev, "nvidia0"), 0, "0000:18:00.0"),
        devutil.Chip(3, os.path.join(dev, "nvidia3"), None, "0000:9a:00.0"),
    ]
    assert info.chip_generation() == "NVIDIA H100 80GB HBM3"
    m = manager.TPUManager(config.TPUConfig(), info)
    m.discover()
    assert sorted(m.devices) == ["nvidia0", "nvidia3"]
    # Advertised devices are the kubelet API's Device messages, as in
    # the JAX package: the NUMA node sits in their topology.
    assert [n.ID for n in m.devices["nvidia0"].topology.nodes] == [0]
    assert not m.devices["nvidia3"].HasField("topology")
    assert [c.uuid for c in info.discover()] == ["GPU-00000000",
                                                 "GPU-00000003"]


def test_sysfs_discovery_without_proc_driver_nvidia(tmp_path):
    # A container may see /dev/nvidia<N> without /proc/driver/nvidia:
    # the cards are found, with no PCI address, NUMA node or model.
    dev, _, _ = _fake_nvidia_tree(tmp_path, {})
    (tmp_path / "dev" / "nvidia0").touch()
    info = devutil.SysfsDeviceInfo(dev_root=dev,
                                   proc_gpus_root=str(tmp_path / "none"),
                                   sysfs_pci_root=str(tmp_path / "none"))
    assert [(c.index, c.pci_address, c.numa_node)
            for c in info.discover()] == [(0, None, None)]
    assert info.chip_generation() == "unknown"
    assert devutil.SysfsDeviceInfo(
        dev_root=str(tmp_path / "missing")).discover() == []


@pytest.mark.parametrize("name,is_chip", [
    ("nvidia0", True), ("nvidia12", True), ("nvidiactl", False),
    ("nvidia-uvm", False), ("nvidia-uvm-tools", False),
    ("nvidia-modeset", False), ("nvidia-caps", False), ("nvidia", False),
    ("accel0", False), ("nvidia0p", False),
])
def test_only_nvidia_n_nodes_are_chips(name, is_chip):
    assert bool(devutil.CHIP_RE.match(name)) == is_chip


def test_sysfs_discovery_takes_char_devices(tmp_path):
    # Real cards are char devices; /dev/null stands in for one here.
    dev = tmp_path / "dev"
    dev.mkdir()
    os.symlink("/dev/null", dev / "nvidia2")
    assert stat.S_ISCHR(os.stat(dev / "nvidia2").st_mode)
    info = devutil.SysfsDeviceInfo(dev_root=str(dev),
                                   proc_gpus_root=str(tmp_path / "none"))
    assert [c.index for c in info.discover()] == [2]


# ---------------------------------------------------------------- wakeq

@pytest.mark.parametrize("mod", [jwakeq, wakeq], ids=["jax", "port"])
def test_wakequeue_semantics(mod):
    q = mod.WakeQueue()
    assert q.empty() and q.qsize() == 0
    with pytest.raises(queue.Empty):
        q.get(timeout=0.01)
    with pytest.raises(queue.Empty):
        q.get_nowait()
    q.put(1)
    q.put(2)
    assert q.qsize() == 2 and q.get(timeout=1) == 1 and q.get_nowait() == 2
    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=5)))
    t.start()
    q.put("late")
    t.join(timeout=5)
    assert got == ["late"]
