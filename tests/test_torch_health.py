"""The port's health path held against the JAX package's on the same
inputs: the tail reader, the raw-log scraper (with the JAX package's
rule table), the JSONL feed, the checker and inject_fault. Then the
port's own rule table against the corpus captured on an H100
(demo/real_fault/logs/), and the plain K7 against the Pallas kernel it
replaces, in interpret mode."""

import dataclasses
import importlib.util
import json
import os
import re
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from container_engine_accelerators_tpu.cli import inject_fault as jinject
from container_engine_accelerators_tpu.deviceplugin import config as jconfig
from container_engine_accelerators_tpu.deviceplugin import devutil as jdevutil
from container_engine_accelerators_tpu.deviceplugin import manager as jmanager
from container_engine_accelerators_tpu.healthcheck import (
    health_checker as jhc,
)
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.cli import inject_fault
from container_engine_accelerators_tpu_torch.demo.real_fault import (
    capture,
    provoke_hbm_oom,
)
from container_engine_accelerators_tpu_torch.deviceplugin import (
    HEALTHY,
    UNHEALTHY,
    config,
    devutil,
    manager,
)
from container_engine_accelerators_tpu_torch.healthcheck import (
    health_checker as hc,
)
from container_engine_accelerators_tpu_torch.ops.scale_demo import (
    scale_demo,
    scale_demo_cuda,
    scale_demo_plain,
)

REPO = Path(__file__).resolve().parents[1]
TPU_LOGS = REPO / "tests" / "fixtures" / "real_tpu_logs"
CARD_LOGS = capture.LOG_DIR

# The raw-log lines of tests/test_healthcheck.py.
SYNTHETIC_LINES = [
    "I0729 libtpu: chip 2: uncorrectable HBM ECC error detected",
    "I0729 hbm scrub: 0 uncorrectable ecc errors",
    "I0729 thermal throttling engaged",
    "I0729 all quiet on the interconnect",
    "W0729 ICI link 3 down on chip 1",
    "E0729 watchdog timeout on host",
    "E0729 thermal shutdown imminent, device 0",
    "ICI link down on device 0000:04:00.0",
    "watchdog timeout at device 0xdead0000",
    "hang on hostA",
    "FATAL frobnicator melted on accel 3",
    "uncorrectable ECC",
    "chip 1 uncorrectable HBM ECC error",
    "ICI link down on chip 2",
]


def _events(events):
    return [(e.chip_index, e.error_class, e.message) for e in events]


def _scrape_both(path, rules=jhc.DEFAULT_SCRAPE_RULES):
    return (_events(hc.RuntimeLogScraperSource(str(path), rules).poll()),
            _events(jhc.RuntimeLogScraperSource(str(path), rules).poll()))


# ---------------------------------------------------------------- scraper

@pytest.mark.parametrize("name", sorted(os.listdir(TPU_LOGS)))
def test_scraper_matches_jax_on_real_tpu_logs(name):
    got, want = _scrape_both(TPU_LOGS / name)
    assert got == want
    if name != "benign_success.log":
        assert got


def test_scraper_matches_jax_on_the_synthetic_lines(tmp_path):
    path = tmp_path / "runtime.log"
    path.write_text("\n".join(SYNTHETIC_LINES) + "\n")
    got, want = _scrape_both(path)
    assert got == want and len(got) == 8
    custom = ((r"hang on (?P<chip>\w+)", "RUNTIME_HANG"),
              (r"frobnicator melted", "THERMAL_TRIP"))
    got, want = _scrape_both(path, custom)
    assert got == want == [
        (-1, "RUNTIME_HANG", "hang on hostA"),
        (3, "THERMAL_TRIP", "FATAL frobnicator melted on accel 3")]


PHRASES = ["uncorrectable HBM ECC error", "0 uncorrectable ecc errors",
           "correctable ecc error", "10 correctable hbm ecc errors",
           "ICI link 3 down", "link layer down", "ici crc error",
           "thermal trip", "thermal throttling", "watchdog timeout",
           "tpu core halted", "runtime stuck",
           "Ran out of memory in memory space hbm",
           "ran out of memory in memory space vmem", "all quiet"]
CHIP_REFS = ["", "on chip 2", "chip 2:", "chip 2:3", "accel_1", "core#0",
             "device 0000:04:00.0", "device 0xdead", "chip 12.5",
             "device: 7"]


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["", "I0729 ", "E0101 12:00 "]),
                          st.sampled_from(PHRASES),
                          st.sampled_from(CHIP_REFS),
                          st.booleans()),
                min_size=1, max_size=8))
def test_scraper_matches_jax_on_generated_lines(lines):
    text = "".join(f"{pre}{phrase} {ref}".rstrip()
                   + (" \xe9" if accent else "") + "\n"
                   for pre, phrase, ref, accent in lines)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "runtime.log"
        path.write_bytes(text.encode("latin-1"))
        got, want = _scrape_both(path)
    assert got == want


# ---------------------------------------------------------------- tail reader

OPS = st.lists(st.one_of(
    st.tuples(st.just("line"), st.sampled_from(["a", "bb", "caf\xe9", ""])),
    st.tuples(st.just("partial"), st.sampled_from(["x", "yy"])),
    st.tuples(st.just("truncate"), st.integers(0, 12)),
    st.tuples(st.just("rotate"), st.sampled_from(["", "new\n", "n\nm\n"])),
    st.tuples(st.just("bytes"), st.sampled_from([b"\xff\xfe\n", b"\x80"])),
), max_size=12)


@settings(max_examples=150, deadline=None)
@given(OPS)
def test_tail_reader_matches_jax_on_file_operations(ops):
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "log"
        path.write_bytes(b"")
        ours, theirs = hc._TailReader(str(path)), jhc._TailReader(str(path))
        for op, arg in ops:
            if op == "line":
                with path.open("ab") as f:
                    f.write(arg.encode("latin-1") + b"\n")
            elif op == "partial":
                with path.open("ab") as f:
                    f.write(arg.encode())
            elif op == "truncate":
                with path.open("r+b") as f:
                    f.truncate(min(arg, f.seek(0, 2)))
            elif op == "rotate":
                path.write_bytes(arg.encode())
            else:
                with path.open("ab") as f:
                    f.write(arg)
            assert ours.read_lines() == theirs.read_lines()
        assert ours._offset == theirs._offset
        path.unlink()
        assert ours.read_lines() == theirs.read_lines() == []


def test_jsonl_feed_matches_jax(tmp_path):
    path = tmp_path / "errors.jsonl"
    path.write_text('{"chip": 0, "class": "THERMAL_TRIP"}\n'
                    '{"chip": 1, "class": "RUNTIME_HANG", "message": "x"}\n'
                    "not-json\n"
                    '{"chip": 2}\n'
                    '{"class": "CHIP_LOST", "message": 3}\n'
                    '{"chip": 3, "class": "HBM_OOM"')
    ours = hc.LogFileErrorSource(str(path))
    theirs = jhc.LogFileErrorSource(str(path))
    assert _events(ours.poll()) == _events(theirs.poll()) == [
        (0, "THERMAL_TRIP", ""), (1, "RUNTIME_HANG", "x"),
        (-1, "CHIP_LOST", "3")]
    with path.open("a") as f:
        f.write("}\n")
    assert _events(ours.poll()) == _events(theirs.poll()) == [
        (3, "HBM_OOM", "")]


# ---------------------------------------------------------------- checker

class RecordingK8s:
    """The checker's duck-typed client, recording each call (condition
    times dropped)."""

    def __init__(self, node=None):
        self.calls = []
        self.node = node or {"metadata": {"name": "node-a"}, "status": {}}

    def create_event(self, ns, body):
        self.calls.append(("create_event", ns, body))

    def set_node_condition(self, name, cond):
        self.calls.append(("set_node_condition", name, {
            k: v for k, v in cond.items() if not k.endswith("Time")}))

    def get_node(self, name):
        self.calls.append(("get_node", name))
        return self.node


class BatchSource:
    """One batch of events per poll."""

    def __init__(self, event_cls, batches):
        self.batches = [[event_cls(*e) for e in b] for b in batches]

    def poll(self):
        return self.batches.pop(0) if self.batches else []


def _fake_dev(root, prefix, n=4):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        (root / f"{prefix}{i}").touch()
    return str(root)


def _checker_pair(tmp_path, batches, layout="plain", critical=None,
                  node=None):
    """(port, JAX) checkers over managers of 4 chips, fed `batches`."""
    boot = tmp_path / "boot_id"
    boot.write_text("boot-1\n")
    pair = []
    for side, cfgmod, devmod, mgrmod, hcmod, prefix in (
            ("port", config, devutil, manager, hc, "nvidia"),
            ("jax", jconfig, jdevutil, jmanager, jhc, "accel")):
        cfg = cfgmod.TPUConfig()
        if layout == "sharing":
            cfg.sharing = cfgmod.SharingConfig("time-sharing", 2)
        elif layout == "subslice":
            cfg.chips_per_partition = 2
        if critical is not None:
            cfg.health_critical_errors = critical
        cfg.validate()
        m = mgrmod.TPUManager(cfg, devmod.MockDeviceInfo(
            _fake_dev(tmp_path / side, prefix)))
        m.discover()
        k8s = RecordingK8s(json.loads(json.dumps(node)) if node else None)
        pair.append(hcmod.TPUHealthChecker(
            m, cfg, sources=[BatchSource(hcmod.ErrorEvent, batches)],
            k8s=k8s, node_name="node-a", boot_id_path=str(boot),
            error_log_path=str(tmp_path / side / "errors.jsonl")))
    return pair


def _state(checker, rename=False):
    summary = checker.error_summary()
    if summary["last_event"]:
        summary["last_event"].pop("t")
    health = {(d.ID.replace("accel", "nvidia") if rename else d.ID): d.health
              for d in checker.manager.snapshot()}
    return summary, health


def _assert_same(ours, theirs):
    assert _state(ours) == _state(theirs, rename=True)
    assert ours.k8s.calls == theirs.k8s.calls


EVENT = st.tuples(st.integers(-1, 3),
                  st.sampled_from(jconfig.KNOWN_ERROR_CLASSES),
                  st.sampled_from(["", "x", "chip 2: boom"]))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(EVENT, max_size=4), min_size=1, max_size=5),
       st.sampled_from(["plain", "sharing", "subslice"]),
       st.sampled_from([None, ("CHIP_LOST", "HBM_OOM"), ()]))
def test_checker_matches_jax_on_event_sequences(batches, layout, critical):
    with tempfile.TemporaryDirectory() as d:
        ours, theirs = _checker_pair(Path(d), batches, layout, critical)
        for _ in batches:
            ours.poll_once()
            theirs.poll_once()
            _assert_same(ours, theirs)


@pytest.mark.parametrize("stored_boot,status", [
    ("boot-1", "True"), ("boot-0", "True"), ("boot-0", "False"), ("", "True"),
])
def test_maybe_reset_condition_matches_jax(tmp_path, stored_boot, status):
    node = {"metadata": {"name": "node-a"}, "status": {"conditions": [{
        "type": "TpuCriticalError", "status": status,
        "message": json.dumps({"bootID": stored_boot,
                               "errors": {"CHIP_LOST": 2}})}]}}
    ours, theirs = _checker_pair(tmp_path, [[(1, "HBM_OOM", "")]],
                                 node=node)
    ours.maybe_reset_condition()
    theirs.maybe_reset_condition()
    _assert_same(ours, theirs)
    ours._last_heartbeat = theirs._last_heartbeat = -1e9
    ours.poll_once()
    theirs.poll_once()
    _assert_same(ours, theirs)


def test_maybe_reset_condition_backoff_matches_jax(tmp_path, monkeypatch):
    class ExplodingK8s(RecordingK8s):
        def get_node(self, name):
            super().get_node(name)
            raise RuntimeError("api server down")

    ours, theirs = _checker_pair(tmp_path, [])
    sleeps = {"port": [], "jax": []}
    for side, checker, mod in (("port", ours, hc), ("jax", theirs, jhc)):
        checker.k8s = ExplodingK8s()
        monkeypatch.setattr(mod.time, "sleep", sleeps[side].append)
        checker.maybe_reset_condition(max_attempts=4)
    assert sleeps["port"] == sleeps["jax"] == [1, 2, 4]
    assert ours.k8s.calls == theirs.k8s.calls


def test_default_sources_and_devfs_presence_match_jax(tmp_path):
    ours, theirs = _checker_pair(tmp_path, [])
    for checker, mod, prefix in ((ours, hc, "nvidia"), (theirs, jhc,
                                                        "accel")):
        cfg = dataclasses.replace(checker.config,
                                  runtime_log_path=str(tmp_path / "rt.log"),
                                  runtime_log_rules=jhc.DEFAULT_SCRAPE_RULES)
        checker.__init__(checker.manager, cfg, k8s=checker.k8s,
                         node_name="node-a",
                         boot_id_path=checker.boot_id_path,
                         error_log_path=str(tmp_path / f"{prefix}.jsonl"))
        assert [type(s).__name__ for s in checker.sources] == [
            "LogFileErrorSource", "DevfsPresenceSource",
            "RuntimeLogScraperSource"]
        os.unlink(checker.manager.device_info.dev_root + f"/{prefix}1")
        (tmp_path / f"{prefix}.jsonl").write_text(
            '{"chip": 2, "class": "HBM_OOM"}\n')
    (tmp_path / "rt.log").write_text("chip 3 uncorrectable HBM ECC error\n")
    ours.poll_once()
    theirs.poll_once()
    assert _state(ours) == _state(theirs, rename=True)
    assert ours.error_summary()["counts"] == {
        "HBM_OOM": 1, "CHIP_LOST": 1, "HBM_ECC_UNCORRECTABLE": 1}
    calls = [c for c in ours.k8s.calls if c[0] == "create_event"]
    assert [c[2]["message"] for c in calls][1] == (
        "TPU chip 1: /dev/nvidia1 disappeared")


def test_health_counters_match_jax(tmp_path):
    batch = [(0, "HBM_OOM", ""), (1, "HBM_OOM", ""),
             (-1, "THERMAL_TRIP", "hot")]
    ours, theirs = _checker_pair(tmp_path, [batch])
    ours.poll_once()
    theirs.poll_once()
    for checker in (ours, theirs):
        assert checker.registry.get_sample_value(
            "tpu_health_events_total", {"error_class": "HBM_OOM"}) == 2
        assert checker.registry.get_sample_value(
            "tpu_health_last_event_timestamp") > 0
    _assert_same(ours, theirs)


# ---------------------------------------------------------------- inject_fault

@pytest.mark.parametrize("argv", [
    [], ["--chip", "-1", "--error-class", "THERMAL_TRIP", "--message", "hot"],
    ["--chip", "2", "--error-class", "HBM_OOM", "--repeat", "3",
     "--interval", "0"],
])
def test_inject_fault_writes_what_jax_writes(tmp_path, argv, capsys):
    paths = []
    for mod, name in ((inject_fault, "port"), (jinject, "jax")):
        path = tmp_path / name / "errors.jsonl"
        assert mod.main([*argv, "--error-log", str(path)]) == 0
        paths.append(path)
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]
    assert paths[0].read_text() == paths[1].read_text()
    with pytest.raises(SystemExit):
        inject_fault.main(["--error-class", "NOPE"])
    with pytest.raises(SystemExit):
        inject_fault.main(["--kind", "hang"])


def test_injected_critical_fault_turns_the_card_unhealthy(tmp_path):
    feed = tmp_path / "errors.jsonl"
    m = manager.TPUManager(config.TPUConfig(), devutil.MockDeviceInfo(
        _fake_dev(tmp_path / "dev", "nvidia", 2)))
    m.discover()
    k8s = RecordingK8s()
    checker = hc.TPUHealthChecker(m, m.config, k8s=k8s, node_name="node-a",
                                  boot_id_path=str(tmp_path / "none"),
                                  error_log_path=str(feed))
    inject_fault.main(["--chip", "0", "--error-log", str(feed)])
    checker.poll_once()
    assert {d.ID: d.health for d in m.snapshot()} == {
        "nvidia0": UNHEALTHY, "nvidia1": HEALTHY}
    events = [c[2] for c in k8s.calls if c[0] == "create_event"]
    assert [(e["type"], e["reason"]) for e in events] == [
        ("Warning", "HBM_ECC_UNCORRECTABLE")]
    cond = [c[2] for c in k8s.calls if c[0] == "set_node_condition"][-1]
    assert cond["status"] == "True" and json.loads(cond["message"]) == {
        "bootID": "unknown", "errors": {"HBM_ECC_UNCORRECTABLE": 1}}


# ---------------------------------------------------------------- card corpus

EXPECTED = {
    # K7 with a 4096-row tile: "ptxas error : Entry function '...' uses
    # too much shared data (0x4000000 bytes, 0xc000 max)".
    "smem_oom.log": [(-1, "VMEM_OOM")],
    # An allocation past the card's 79.18 GiB: "CUDA out of memory.
    # Tried to allocate 80.18 GiB. GPU 0 has ...".
    "hbm_oom.log": [(0, "HBM_OOM")],
    "benign_success.log": [],
}


def test_card_corpus_is_the_capture_set():
    assert sorted(os.listdir(CARD_LOGS)) == sorted(EXPECTED)
    assert sorted(f"{name}.log" for name in capture.RUNS) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_card_capture_classifies_to_its_class(name):
    events = hc.RuntimeLogScraperSource(str(CARD_LOGS / name)).poll()
    assert [(e.chip_index, e.error_class) for e in events] == EXPECTED[name]


def test_no_line_of_the_card_corpus_trips_a_critical_class(tmp_path):
    for name in EXPECTED:
        for line in (CARD_LOGS / name).read_text().splitlines():
            path = tmp_path / "one.log"
            path.write_text(line + "\n")
            for e in hc.RuntimeLogScraperSource(str(path)).poll():
                assert e.error_class not in config.DEFAULT_CRITICAL, line


def test_card_oom_counts_without_evicting(tmp_path):
    log = tmp_path / "runtime.log"
    log.write_text("".join((CARD_LOGS / name).read_text()
                           for name in sorted(EXPECTED)))
    cfg = config.TPUConfig(runtime_log_path=str(log))
    m = manager.TPUManager(cfg, devutil.MockDeviceInfo(
        _fake_dev(tmp_path / "dev", "nvidia", 2)))
    m.discover()
    k8s = RecordingK8s()
    checker = hc.TPUHealthChecker(m, cfg, k8s=k8s, node_name="node-a",
                                  error_log_path=str(tmp_path / "e.jsonl"))
    checker.poll_once()
    assert checker.error_summary()["counts"] == {"HBM_OOM": 1,
                                                 "VMEM_OOM": 1}
    assert not checker.error_summary()["critical_seen"]
    assert {d.health for d in m.snapshot()} == {HEALTHY}
    assert [c[2]["type"] for c in k8s.calls if c[0] == "create_event"] == [
        "Normal", "Normal"]
    assert not any(c[0] == "set_node_condition" for c in k8s.calls)


# ---------------------------------------------------------------- port rules

@pytest.mark.parametrize("line,want", [
    ("NVRM: Xid (PCI:0000:18:00): 48, pid=1234, name=python, DBE (Double "
     "Bit Error) ECC Error", (-1, "HBM_ECC_UNCORRECTABLE")),
    ("NVRM: Xid (PCI:0000:18:00): 95, pid=1234, name=python, Uncontained: "
     "FBHUB", (-1, "HBM_ECC_UNCORRECTABLE")),
    ("NVRM: Xid (PCI:0000:18:00): 92, High single-bit ECC error rate",
     (-1, "HBM_ECC_CORRECTABLE")),
    ("NVRM: Xid (PCI:0000:18:00): 74, pid=1, NVLink: fatal error detected "
     "on link 4", (-1, "ICI_LINK_DOWN")),
    ("NVRM: Xid (PCI:0000:18:00): 79, pid='<unknown>', name=<unknown>, GPU "
     "has fallen off the bus.", (-1, "CHIP_LOST")),
    ("NVRM: GPU 0000:18:00.0: GPU has fallen off the bus.",
     (-1, "CHIP_LOST")),
    # "GPU0" names a card, so this one is not host-wide.
    ("NVRM: Xid (PCI:0000:18:00): 119, pid=1, Timeout after 6s of waiting "
     "for RPC response from GPU0 GSP!", (0, "RUNTIME_HANG")),
    ("NVRM: Xid (PCI:0000:18:00): 480, unknown", None),
    ("NVRM: Xid (PCI:0000:18:00): 31, pid=1, MMU Fault", None),
    ("Xid 48 on GPU 3: double bit ECC", None),
    ("NVRM: Xid (PCI:0000:18:00): 48, on GPU 3", (3, "HBM_ECC_UNCORRECTABLE")),
    ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 "
     "GiB. GPU 1 has a total capacity of 79.18 GiB", (1, "HBM_OOM")),
    ("ptxas info    : Used 40 registers, used 1 barriers, 67108864 bytes "
     "smem", None),
    ("ptxas error   : Entry function 'k' uses too much shared data "
     "(0x4000000 bytes, 0xc000 max)", (-1, "VMEM_OOM")),
])
def test_port_rules_on_nvidia_lines(tmp_path, line, want):
    path = tmp_path / "runtime.log"
    path.write_text(line + "\n")
    got = [(e.chip_index, e.error_class)
           for e in hc.RuntimeLogScraperSource(str(path)).poll()]
    assert got == ([want] if want else [])


def test_port_rule_classes_are_known_and_ooms_not_critical():
    for pat, cls in hc.DEFAULT_SCRAPE_RULES:
        re.compile(pat)
        assert cls in config.KNOWN_ERROR_CLASSES
    for cls in ("HBM_OOM", "VMEM_OOM"):
        assert cls not in config.DEFAULT_CRITICAL
    assert {cls for _, cls in hc.DEFAULT_SCRAPE_RULES} >= {
        "HBM_ECC_UNCORRECTABLE", "ICI_LINK_DOWN", "CHIP_LOST", "HBM_OOM",
        "VMEM_OOM"}


# ---------------------------------------------------------------- K7

def _pallas_k7():
    path = REPO / "demo" / "tpu-error" / "real-fault" / "provoke_vmem_oom.py"
    spec = importlib.util.spec_from_file_location("provoke_vmem_oom", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel


@pytest.mark.parametrize("shape", [(8, 128), (64, 256)])
def test_plain_k7_matches_the_pallas_kernel(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = pl.pallas_call(
        _pallas_k7(), out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = scale_demo_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scale_demo(torch.from_numpy(x)).numpy(),
                                  x * 2.0)


def test_k7_wrapper_refuses_before_launch():
    kernels.reset_launches()
    with pytest.raises(ValueError):
        scale_demo_cuda(torch.ones(4))
    with pytest.raises(ValueError):
        scale_demo(torch.ones(4, device="meta"))
    assert not kernels.launches


def test_provocations_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    assert provoke_hbm_oom.main() == 2
