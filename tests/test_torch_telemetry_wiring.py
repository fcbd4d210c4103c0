"""Device telemetry's wiring in the port, held against the JAX package on
the CPU: the memory plan (utils/hbm_plan.py against tools/hbm_plan.py at
the same capacity), the plan expectation and the OOM bundle's hbm_plan
block (metrics/introspection.py), the profiler hooks (utils/
profiling.py: annotate's B/E pair, maybe_profile's capture and marks),
FaultListener's fabric_slow command, the doctor's plan evidence, train's
sweeps by step, and serve --fabric-health's /debugz?state=1 fabric block.
Tolerance: exact (the plans are the same float arithmetic)."""

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import types
import urllib.request

import pytest
import torch

from container_engine_accelerators_tpu.metrics import doctor as jdoctor
from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import fabric_health as jfh
from container_engine_accelerators_tpu.metrics import introspection as jintro
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.utils import profiling as jprof
from container_engine_accelerators_tpu_torch.metrics import doctor as tdoctor
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import (
    fabric_health as tfh,
)
from container_engine_accelerators_tpu_torch.metrics import (
    introspection as tintro,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.training import (
    train as ttrain,
)
from container_engine_accelerators_tpu_torch.training.data import (
    synthetic_batches,
)
from container_engine_accelerators_tpu_torch.utils import hbm_plan
from container_engine_accelerators_tpu_torch.utils import profiling as tprof
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401
from tools import hbm_plan as jplan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"llama3_8b": (jllama.llama3_8b, tllama.llama3_8b),
        "llama_tiny": (jllama.llama_tiny, tllama.llama_tiny)}


@pytest.fixture(autouse=True)
def clean_state():
    def reset():
        for ev in (jevents, tevents):
            ev._reset_for_tests()
        jintro._reset_for_tests()
        tintro.set_expected_hbm(None)
        for fh in (jfh, tfh):
            fh.set_active(None)
            fh.clear_injection()
    reset()
    yield
    reset()


# ---------- utils/hbm_plan ----------

@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("chip", ["v5e", "v5p"])
def test_plan_serving_equals_tools_hbm_plan(name, chip):
    jcfg, tcfg = (f() for f in CFGS[name])
    cap = jplan.CHIP_HBM[chip]
    for tp in (1, 4):
        for kv in ("bf16", "int8", "int4"):
            for weights in ("bf16", "int8"):
                for frac in (0.25, 0.5, 1.0):
                    kw = dict(tp=tp, max_slots=16, max_len=4096,
                              pool_fraction=frac, kv_dtype=kv,
                              weight_dtype=weights)
                    assert hbm_plan.plan_serving(
                        tcfg, chip=chip, hbm_bytes=cap, **kw) == \
                        jplan.plan_serving(jcfg, chip=chip, **kw), kw
    assert hbm_plan.plan_serving(tcfg, chip=chip, hbm_bytes=cap,
                                 host_tier_gb=64.0) == jplan.plan_serving(
        jcfg, chip=chip, host_tier_gb=64.0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_plan_training_equals_tools_hbm_plan(name):
    jcfg, tcfg = (f() for f in CFGS[name])
    for chip in ("v5e", "v5p"):
        cap = jplan.CHIP_HBM[chip]
        for mesh in ({}, {"fsdp": 64}, {"dp": 2, "tp": 4}, {"pp": 2}):
            for batch, seq in ((1, 2048), (5, 2048), (4, 8192)):
                kw = dict(batch_size=batch, seq_len=seq, **mesh)
                assert hbm_plan.plan_training(
                    tcfg, chip=chip, hbm_bytes=cap, **kw) == \
                    jplan.plan_training(jcfg, chip=chip, **kw), kw


def test_plan_needs_a_capacity_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(ValueError, match="hbm_bytes"):
        hbm_plan.plan_serving(tllama.llama_tiny())
    plan = hbm_plan.plan_serving(tllama.llama_tiny(), hbm_bytes=80e9,
                                 chip="NVIDIA H100 80GB HBM3")
    assert plan["chip"] == "NVIDIA H100 80GB HBM3" and plan["hbm_gb"] == 80.0


# ---------- introspection: the expectation and the bundle ----------

ROWS = [{"device": "cuda:0", "stats_available": True,
         "bytes_in_use": 30_000_000_000, "peak_bytes_in_use": 41_234_567_890,
         "bytes_limit": 85_000_000_000},
        {"device": "cuda:1", "stats_available": True,
         "bytes_in_use": 10_000_000_000, "bytes_limit": 85_000_000_000},
        {"device": "cuda:2", "stats_available": False}]


@pytest.mark.parametrize("rows", [ROWS, [], ROWS[2:]])
def test_bundle_hbm_plan_block_equals_jax(monkeypatch, rows):
    plan = jplan.plan_serving(jllama.llama3_8b(), chip="v5p")
    for intro in (jintro, tintro):
        intro.set_expected_hbm(plan)
        monkeypatch.setattr(intro, "device_memory_stats",
                            lambda include_unavailable=False, rows=rows: [
                                dict(r) for r in rows])
    got = tintro.build_oom_bundle("fit/step")["hbm_plan"]
    want = jintro.build_oom_bundle("fit/step")["hbm_plan"]
    assert got == want
    assert tintro.expected_hbm() == jintro.expected_hbm() == plan
    if rows == ROWS:
        assert got["comparison"] == {
            "expected_total_gb": plan["total_gb"],
            "expected_fits": plan["fits"], "observed_peak_gb": 41.235,
            "observed_device": "cuda:0"}
    tintro.set_expected_hbm(None)
    assert tintro.build_oom_bundle("x")["hbm_plan"] == {
        "expected": None, "comparison": None}


def test_doctor_attaches_the_expectation():
    plan = hbm_plan.plan_serving(tllama.llama_tiny(), hbm_bytes=80e9,
                                 chip="card")
    assert tdoctor._expected_hbm() is None
    tintro.set_expected_hbm(plan)
    jintro.set_expected_hbm(plan)
    assert tdoctor._expected_hbm() == jdoctor._expected_hbm() == plan


def test_snapshot_memory_to_bus_equals_jax(monkeypatch):
    rows = [{"device": "cuda:0", "bytes_in_use": 5, "peak_bytes_in_use": 7,
             "bytes_limit": 11, "allocated_bytes": 3}, {"device": "cuda:1"}]
    events = {}
    for name, intro, ev in (("jax", jintro, jevents),
                            ("torch", tintro, tevents)):
        monkeypatch.setattr(intro, "device_memory_stats",
                            lambda rows=rows: [dict(r) for r in rows])
        intro.snapshot_memory_to_bus("off")     # bus off: nothing
        bus = ev.enable(capacity=64, process_name=name)
        intro.snapshot_memory_to_bus("on")
        events[name] = [(e[0], e[3], e[4], e[7]) for e in bus.snapshot()
                        if e is not None]
    assert events["torch"] == events["jax"] == [
        ("C", "hbm/cuda:0", "hbm", {"bytes_in_use": 5,
                                    "peak_bytes_in_use": 7,
                                    "bytes_limit": 11})]


# ---------- utils/profiling ----------

def _ring(ev) -> list:
    return [(e[0], e[3], e[4], e[7]) for e in ev.get_bus().snapshot()
            if e is not None]


def test_annotate_pairs_equal_jax():
    got = {}
    for name, prof, ev in (("jax", jprof, jevents),
                           ("torch", tprof, tevents)):
        with prof.annotate("serve/decode_tick"):
            pass                          # bus off: no event
        bus = ev.enable(capacity=64, process_name=name)
        with prof.annotate("serve/admit"):
            with prof.annotate("serve/prefill_chunk"):
                pass
        with pytest.raises(KeyError), prof.annotate("train/step"):
            raise KeyError("the E still lands")
        got[name] = _ring(ev)
        assert bus.emitted == 6
    assert got["torch"] == got["jax"]
    assert [e[1] for e in got["torch"]][:2] == ["serve/admit",
                                                "serve/prefill_chunk"]


def test_annotate_with_nothing_on_allocates_nothing():
    """The disabled path hands back one shared no-op context."""
    assert tprof.annotate("a") is tprof.annotate("b") is tprof._NULL


def test_maybe_profile_writes_a_trace_with_jaxs_marks(tmp_path):
    marks, traces = {}, {}
    for name, prof, ev in (("jax", jprof, jevents),
                           ("torch", tprof, tevents)):
        ev.enable(capacity=256, process_name=name)
        d = str(tmp_path / name)
        with prof.maybe_profile(d) as on:
            assert on
            with prof.annotate("train/step"):
                torch.ones(8).sum()
        marks[name] = [(ph, n, cat, args) for ph, n, cat, args in _ring(ev)
                       if n.startswith("profile/")]
        traces[name] = os.listdir(d)
        ev._reset_for_tests()
    want = [("i", "profile/start", "xplane",
             {"log_dir": str(tmp_path / "jax")}),
            ("i", "profile/stop", "xplane", None)]
    assert marks["jax"] == want
    assert marks["torch"] == [(ph, n, c, a if a is None else {
        "log_dir": str(tmp_path / "torch")}) for ph, n, c, a in want]
    (trace,) = traces["torch"]
    with open(tmp_path / "torch" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "train/step" in names


def test_maybe_profile_unset_and_busy(tmp_path, monkeypatch, caplog):
    monkeypatch.delenv(tprof.PROFILE_DIR_ENV, raising=False)
    with tprof.maybe_profile() as on:
        assert on is False
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tprof.maybe_profile(str(tmp_path / "p")) as on:
            assert on is False         # never two profilers at once
    assert not (tmp_path / "p").exists()
    assert any("another profiler is active" in r.getMessage()
               for r in caplog.records)


# ---------- chaos, training, serving ----------

@pytest.mark.parametrize("rec", [
    {"kind": "fabric_slow"},
    {"kind": "fabric_slow", "axis": "tp", "rank": 3, "factor": 4.0,
     "seconds": 30.0, "delay_s": 0.005}])
def test_fault_listener_fabric_slow_arms_jaxs_injection(tmp_path, rec):
    got = {}
    for name, doc, fh in (("jax", jdoctor, jfh), ("torch", tdoctor, tfh)):
        listener = doc.FaultListener(str(tmp_path / f"{name}.jsonl"))
        listener._apply(dict(rec))
        inj = dict(fh._INJECT)
        inj["until"] -= time.monotonic()
        got[name] = inj
        fh.clear_injection()
    assert got["torch"].pop("until") == pytest.approx(
        got["jax"].pop("until"), abs=0.5)
    assert got["torch"] == got["jax"]


class _CountingMonitor:
    """What fit reads of the active monitor, counting the sweeps its
    maybe_sweep_step runs."""

    def __init__(self, every):
        self.train_every = every
        self.swept = []

    def maybe_sweep_step(self, step):
        if step % self.train_every == 0:
            self.swept.append(step)
            return True
        return False


def test_fit_sweeps_at_jaxs_steps_and_annotates(two_torch_threads):
    cfg = dataclasses.replace(tllama.llama_tiny(), n_layers=1)
    mon = _CountingMonitor(2)
    tfh.set_active(mon)
    bus = tevents.enable(capacity=1 << 12, process_name="train")
    ttrain.fit(cfg, ttrain.make_optimizer(),
               synthetic_batches(cfg.vocab_size, 2, 16, seed=0),
               device="cpu", max_steps=6, log_every=0)
    jmon = jfh.FabricHealthMonitor(
        mesh=types.SimpleNamespace(shape={"dp": 1}),
        probe_fn=lambda axis, coll: 1e9)
    jmon.train_every = 2
    assert mon.swept == [s for s in range(1, 7) if jmon.maybe_sweep_step(s)]
    spans = [(e[0], e[3]) for e in bus.snapshot()
             if e is not None and e[4] == "xplane"]
    for region in ("train/data_wait", "train/step", "train/fabric_sweep"):
        assert spans.count(("B", region)) == spans.count(("E", region)) == 6


def test_serve_fabric_health_state_block_has_jaxs_keys(tmp_path,
                                                      two_torch_threads):
    """serve --fabric-health --device cpu (gloo, one rank): the
    /debugz?state=1 fabric block carries the keys of the JAX monitor's
    snapshot, its axes' too."""
    log = tmp_path / "serve.err"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "container_engine_accelerators_tpu_torch."
             "cli.serve", "--tiny", "--device", "cpu", "--engine", "paged",
             "--port", "0", "--metrics-port", "0", "--metrics-host",
             "127.0.0.1", "--fabric-health", "--fabric-health-interval",
             "0.1"], cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
            env=dict(os.environ, PYTHONPATH=REPO))
    try:
        port, fabric, deadline = None, {}, time.monotonic() + 120
        while fabric.get("sweeps", 0) < 2:
            assert time.monotonic() < deadline and proc.poll() is None, \
                log.read_text()[-2000:]
            time.sleep(0.05)
            if port is None:
                m = re.search(r"request metrics on :(\d+)", log.read_text())
                port = int(m.group(1)) if m else None
                continue
            with contextlib.suppress(OSError):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/debugz?n=0&state=1",
                        timeout=10) as r:
                    fabric = json.loads(r.read())["state"].get("fabric", {})
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    jmon = jfh.FabricHealthMonitor(
        mesh=types.SimpleNamespace(shape={"dp": 1}),
        probe_fn=lambda axis, coll: 1e9)
    jmon.sweep_once()
    want = jmon.snapshot()
    assert set(fabric) == set(want)
    assert set(fabric["axes"]) == {"dp"}
    assert set(fabric["axes"]["dp"]) == set(want["axes"]["dp"])
    assert fabric["axes"]["dp"]["fabric"] == "ici"
