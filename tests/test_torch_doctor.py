"""The port's doctor (metrics/doctor.py) held against the JAX package's on
the CPU. Each detector gets one synthetic flight-recorder timeline (its
timestamps jittered from a numpy seed), replayed through `doctor.replay`
of both packages: the incident lists must be equal in class, subject,
summary and evidence, with confidence within 1e-9 (wall-clock stamps,
pids and bundle paths excluded). Then the doctor's metric families,
`trace doctor` (stdout and exit code), every `inject_fault` kind (the
same JSONL bytes), the FaultListener's kinds against the JAX listener's,
the recorder's `state_snapshot` and `/debugz?state=1` after the same
requests through both packages' engines (one-layer f32 llama_tiny,
weights carried across by interop.params_from_jax), the replica stamp,
and the live path: a port llama_tiny continuous engine on the CPU with a
live Doctor and FaultListener names `engine_hang` under `inject_fault
--kind hang`, and its own dump, replayed by the JAX package's doctor,
gives the same verdict. Tolerance: exact, except confidence (1e-9)."""

import json
import logging
import os
import queue
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.cli import inject_fault as jinject
from container_engine_accelerators_tpu.cli import serve as jserve
from container_engine_accelerators_tpu.cli import trace as jtrace_cli
from container_engine_accelerators_tpu.metrics import doctor as jdoctor
from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import request_metrics as jrm
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.training import dataset as jdataset
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import inject_fault
from container_engine_accelerators_tpu_torch.cli import serve as tserve
from container_engine_accelerators_tpu_torch.cli import trace as ttrace_cli
from container_engine_accelerators_tpu_torch.cli import train as ttrain_cli
from container_engine_accelerators_tpu_torch.metrics import doctor as tdoctor
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.training import (
    dataset as tdataset,
)

SEED = 15
BASE = 100.0              # seconds; the synthetic timelines start here
DOCTORS = {"jax": (jdoctor, jevents), "torch": (tdoctor, tevents)}
# Incident fields that follow the wall clock, the process or a path.
VOLATILE = ("t", "pid", "bundle_path")


@pytest.fixture(autouse=True)
def clean():
    def reset():
        for doc, ev in DOCTORS.values():
            ev._reset_for_tests()
            doc.set_active(None)
        tdataset.clear_stall()
        jdataset.clear_stall()
    reset()
    yield
    reset()


# ---------------------------------------------------------------- timelines

class Timeline:
    """Chrome-trace events at BASE + t seconds, each jittered by up to 20
    ms from a numpy seed so no two timelines share a grid."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.events: list[dict] = []

    def _ts(self, t: float) -> float:
        return round((BASE + t + float(self.rng.uniform(0, 0.02))) * 1e6, 3)

    def add(self, ph, name, t, args=None, eid=None):
        ev = {"name": name, "cat": "test", "ph": ph, "ts": self._ts(t),
              "pid": 1, "tid": 1}
        if args:
            ev["args"] = args
        if eid is not None:
            ev["id"] = str(eid)
        self.events.append(ev)

    def counter(self, name, t, **vals):
        self.add("C", name, t, vals)

    def instant(self, name, t, **args):
        self.add("i", name, t, args)

    def trace(self) -> dict:
        return {"traceEvents": [{"name": "process_name", "ph": "M",
                                 "pid": 1, "tid": 0,
                                 "args": {"name": "test"}}] + self.events}


def _engine_hang(tl):
    for k in range(13):                       # busy until t 3, then silence
        tl.counter("serve/slots", 0.25 * k, active=2, total=4)
        tl.counter("serve/decode_step_ms", 0.25 * k, ms=4.0)
    tl.counter("serve/queue_depth", 9.0, queued=0)


def _recompile_storm(tl):
    for k in range(4):
        tl.instant("xla/recompile", 1.0 + k, fn="decode_step",
                   diff=f"tokens: (8, {16 * k}) -> (8, {16 * k + 16})")
    tl.counter("serve/queue_depth", 6.0, queued=0)


def _oom_precursor(tl):
    limit = 85_899_345_920
    for k, frac in enumerate(np.linspace(0.5, 0.97, 8)):
        frac += float(tl.rng.uniform(0, 0.004))
        tl.counter("hbm/cuda:0", 0.5 * k, bytes_in_use=int(limit * frac),
                   peak_bytes_in_use=int(limit * frac), bytes_limit=limit)
    tl.counter("serve/queue_depth", 6.0, queued=0)


def _queue_collapse(tl):
    for k in range(8):
        tl.counter("serve/queue_depth", 0.5 * k, queued=1 + k)
        tl.counter("serve/pool_depth", 0.5 * k, prefill=1 + k, decode=0)
    tl.counter("serve/slots", 6.0, active=0, total=4)


def _straggler(tl):
    for t in (2.0, 3.5):
        tl.instant("train/stalled", t, process=1,
                   age_s=round(12.0 + float(tl.rng.uniform(0, 3)), 1),
                   overdue=1)
    tl.instant("ckpt/async_save", 1.0, process=0, phase="start")
    tl.counter("train/goodput_fraction", 5.0, fraction=0.9)


def _health_storm(tl):
    for k in range(4):
        tl.instant("health/HBM_ECC_UNCORRECTABLE", 1.0 + 0.3 * k, chip=0,
                   critical=True, message="injected by inject_fault")
    tl.instant("health/HBM_OOM", 2.5, chip=0, critical=False,
               message="CUDA out of memory")
    tl.counter("serve/queue_depth", 6.0, queued=0)


def _slo_burn(tl):
    for k in range(8):
        t0 = 0.3 * k
        tl.add("b", "request", t0, eid=k)
        ttft = (0.1 if k % 4 == 0 else float(tl.rng.uniform(0.6, 1.5)))
        tl.add("n", "first_token", t0 + ttft, eid=k)
        tl.add("e", "request", t0 + ttft + 0.5, eid=k)
    tl.counter("train/goodput_fraction", 4.0, fraction=0.1)
    tl.counter("serve/queue_depth", 6.0, queued=0)


def _queue_storm(tl):
    for k in range(5):
        t0 = 0.2 * k
        tl.add("b", "req/queue", t0, eid=k)
        tl.add("e", "req/queue", t0 + float(tl.rng.uniform(1.0, 2.0)),
               eid=k)
    tl.counter("serve/queue_depth", 5.0, queued=0)


def _page_stall(tl):
    for k in range(3):
        t0 = 0.5 * k
        tl.add("b", "req/page_stall", t0, eid=10 + k)
        tl.add("e", "req/page_stall",
               t0 + float(tl.rng.uniform(0.4, 0.8)), eid=10 + k)
    tl.add("b", "req/page_stall", 3.0, eid=20)      # never resolves
    tl.counter("serve/queue_depth", 5.0, queued=1)


def _kv_cold_waste(tl):
    for k in range(4):
        tl.counter("serve/kv_thermal", 0.5 + k, hot=2, warm=2,
                   cold=12 + k, wss=4)
        tl.counter("serve/kv_tenant_cold", 0.5 + k, **{"0": 8, "1": 4 + k})
    tl.add("b", "req/page_stall", 1.0, eid=7)       # open: still stalled
    tl.counter("serve/queue_depth", 5.0, queued=1)


def _kv_thrash(tl):
    for k in range(4):
        tl.instant("kv/thrash", 0.5 + 0.5 * k, page=3 + k,
                   age_s=round(float(tl.rng.uniform(0.1, 2.0)), 3))
    tl.counter("serve/queue_depth", 5.0, queued=0)


def _fabric_degraded(tl):
    for k in range(4):
        tl.counter("fabric/health", 0.5 + k,
                   dp=round(0.5 - 0.05 * k, 3), tp=0.98)
        tl.counter("fabric/busbw_gbps", 0.5 + k,
                   **{"all_reduce.dp.ici": 40.0 - k,
                      "all_reduce.tp.ici": 180.0})
    tl.instant("fabric/degraded", 2.6, axis="dp", fabric="ici",
               collective="all_reduce", slow_rank=3,
               busbw_bytes_per_second=4.0e10,
               baseline_bytes_per_second=9.0e10)
    tl.counter("serve/queue_depth", 5.0, queued=0)


def _fabric_flap(tl):
    for k in range(8):
        tl.counter("fabric/health", 0.5 * k,
                   dp=0.95 if k % 2 == 0 else 0.4)
    tl.counter("serve/queue_depth", 5.0, queued=0)


SCENARIOS = {
    "engine_hang": _engine_hang, "recompile_storm": _recompile_storm,
    "oom_precursor": _oom_precursor, "queue_collapse": _queue_collapse,
    "straggler": _straggler, "health_storm": _health_storm,
    "slo_burn": _slo_burn, "queue_storm": _queue_storm,
    "page_stall": _page_stall, "kv_cold_waste": _kv_cold_waste,
    "kv_thrash": _kv_thrash, "fabric_degraded": _fabric_degraded,
    "fabric_flap": _fabric_flap,
}


def small_config(doctor):
    """One small configuration, built from either package's classes."""
    return doctor.DoctorConfig(
        poll_interval_s=0.5, fast_window_s=10.0, slow_window_s=50.0,
        hang_after_s=2.0, hbm_min_samples=4, queue_min_depth=4,
        health_storm_n=3, straggler_skew_s=5.0, clear_after_s=1e9,
        slos=[doctor.SloSpec("ttft_p99", "ttft", threshold_s=0.5,
                             objective=0.9, min_samples=4, fast_burn=2.0,
                             slow_burn=1.0),
              doctor.SloSpec("goodput", "goodput", objective=0.5,
                             fast_burn=1.5, slow_burn=1.0)])


def stable(incidents: list[dict]) -> list[dict]:
    return [{k: v for k, v in inc.items() if k not in VOLATILE}
            for inc in incidents]


def assert_same_incidents(ours: list[dict], theirs: list[dict]) -> None:
    a, b = stable(ours), stable(theirs)
    assert [i["confidence"] for i in a] == pytest.approx(
        [i["confidence"] for i in b], abs=1e-9)
    for i in a + b:
        i.pop("confidence")
    assert a == b


def replay_both(trace: dict, **kw) -> dict:
    return {pkg: doc.replay(trace, config=small_config(doc), **kw)
            for pkg, (doc, _) in DOCTORS.items()}


# ---------------------------------------------------------------- detectors

@pytest.mark.parametrize("cls", sorted(SCENARIOS))
def test_replay_matches_jax_per_detector(cls):
    tl = Timeline(SEED + sorted(SCENARIOS).index(cls))
    SCENARIOS[cls](tl)
    got = replay_both(tl.trace())
    assert cls in [i["class"] for i in got["torch"]], got["torch"]
    assert_same_incidents(got["torch"], got["jax"])


def test_clean_timeline_is_quiet_in_both():
    tl = Timeline(SEED)
    for k in range(20):
        tl.counter("serve/slots", 0.25 * k, active=1, total=4)
        tl.counter("serve/decode_step_ms", 0.25 * k, ms=4.0)
        tl.counter("serve/queue_depth", 0.25 * k, queued=k % 2)
    got = replay_both(tl.trace())
    assert got == {"jax": [], "torch": []}


def test_registry_is_the_jax_registry():
    assert ([d.cls for d in tdoctor.default_detectors()]
            == [d.cls for d in jdoctor.default_detectors()])
    assert (tdoctor.DoctorConfig().summary()
            == jdoctor.DoctorConfig().summary())


def _families(registry) -> dict:
    return {c._name: (c._type, tuple(c._labelnames), c._documentation)
            for c in registry._collector_to_names}


def test_metric_families_equal_jax():
    from prometheus_client import CollectorRegistry

    fams = {}
    for pkg, (doc, _) in DOCTORS.items():
        d = doc.Doctor(registry=CollectorRegistry(), out_dir=None,
                       live=False)
        fams[pkg] = _families(d.registry)
    assert fams["torch"] == fams["jax"]
    assert set(fams["torch"]) == {"tpu_doctor_incidents",
                                  "tpu_slo_burn_rate",
                                  "tpu_doctor_active_incidents",
                                  "tpu_doctor_evals"}


def test_bundles_and_dedup_match_jax(tmp_path):
    tl = Timeline(SEED + 40)
    _health_storm(tl)
    _oom_precursor(tl)
    got = {pkg: doc.replay(tl.trace(), config=small_config(doc),
                           out_dir=str(tmp_path / pkg))
           for pkg, (doc, _) in DOCTORS.items()}
    assert_same_incidents(got["torch"], got["jax"])
    for pkg, incs in got.items():
        assert sorted(i["class"] for i in incs) == ["health_storm",
                                                    "oom_precursor"]
        for inc in incs:
            with open(inc["bundle_path"]) as f:
                assert json.load(f)["class"] == inc["class"]
        assert not [p for p in os.listdir(tmp_path / pkg) if ".tmp." in p]


# ---------------------------------------------------------------- trace CLI

def test_trace_doctor_cli_matches_jax(tmp_path, capsys):
    tl = Timeline(SEED + 50)
    _engine_hang(tl)
    _health_storm(tl)
    # --window 10 caps hang_after_s at 10 s: the silence runs past it.
    tl.counter("serve/queue_depth", 16.0, queued=0)
    path = tmp_path / "merged.json"
    path.write_text(json.dumps(tl.trace()))
    runs = {}
    for pkg, cli in (("torch", ttrace_cli), ("jax", jtrace_cli)):
        text_rc = cli.main(["doctor", str(path), "--window", "10",
                            "--interval", "0.5"])
        text = capsys.readouterr().out
        json_rc = cli.main(["doctor", str(path), "--window", "10",
                            "--interval", "0.5", "--json",
                            "--fail-on-incident"])
        lines = [json.loads(line) for line in
                 capsys.readouterr().out.splitlines()]
        runs[pkg] = (text_rc, text, json_rc, lines)
    t_text_rc, t_text, t_json_rc, t_lines = runs["torch"]
    j_text_rc, j_text, j_json_rc, j_lines = runs["jax"]
    assert (t_text_rc, t_text, t_json_rc) == (j_text_rc, j_text, j_json_rc)
    assert (t_text_rc, t_json_rc) == (0, 1)
    assert "[engine_hang] serve" in t_text
    assert_same_incidents(t_lines, j_lines)
    # A clean trace passes the gate in both.
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps({"traceEvents": []}))
    for cli in (ttrace_cli, jtrace_cli):
        assert cli.main(["doctor", str(clean), "--fail-on-incident"]) == 0
    assert capsys.readouterr().out.count("0 incident(s)") == 2


# ---------------------------------------------------------------- inject_fault

KINDS = {
    "health": ["--chip", "1", "--error-class", "HBM_OOM", "--repeat", "2",
               "--interval", "0"],
    "hang": ["--seconds", "7.5"],
    "worker-kill": [],
    "prefill-kill": [],
    "recompile-storm": ["--count", "6"],
    "hbm-climb": ["--device", "cuda:0", "--seconds", "2.5",
                  "--start-frac", "0.6", "--end-frac", "0.99"],
    "queue-collapse": ["--depth", "12", "--seconds", "1.5"],
    "data-stall": ["--seconds", "4"],
    "straggler": ["--delay", "2.5", "--seconds", "0"],
    "health-tail": ["--path", "PATH", "--seconds", "9"],
    "fabric-slow": ["--axis", "tp", "--rank", "3", "--factor", "4"],
}


def test_fault_kinds_are_jax_kinds():
    assert inject_fault.FAULT_KINDS == jinject.FAULT_KINDS
    assert sorted(KINDS) == sorted(jinject.FAULT_KINDS)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_inject_fault_kind_writes_what_jax_writes(tmp_path, capsys, kind):
    outs, files = [], []
    for mod, pkg in ((inject_fault, "torch"), (jinject, "jax")):
        path = tmp_path / pkg / "log.jsonl"
        argv = ["--kind", kind,
                *[str(tmp_path / "errors.jsonl") if a == "PATH" else a
                  for a in KINDS[kind]],
                "--error-log" if kind == "health" else "--fault-log",
                str(path)]
        assert mod.main(argv) == 0
        outs.append(capsys.readouterr().out.replace(str(path), "LOG"))
        files.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert files[0] == files[1]
    rec = json.loads(files[0].splitlines()[0])
    if kind != "health":
        assert rec["kind"] == kind.replace("-", "_")


# ---------------------------------------------------------------- listener

class _Engine:
    fault_hang_s = 0.0
    fault_kill = False
    fault_kill_prefill = False


def _listener(doctor, tmp_path, engine=None):
    return doctor.FaultListener(str(tmp_path / "unused.jsonl"),
                                engine=engine)


def _bus_events(ev) -> list[tuple]:
    return [(e["ph"], e["name"], e.get("args"))
            for e in ev.get_bus().to_chrome()["traceEvents"]
            if e["ph"] != "M"]


@pytest.mark.parametrize("rec", [
    {"kind": "hang", "seconds": 2.5}, {"kind": "worker_kill"},
    {"kind": "prefill_kill"},
    {"kind": "hbm_climb", "device": "cuda:0", "seconds": 0.2,
     "start_frac": 0.5, "end_frac": 0.97, "limit": 85899345920},
    {"kind": "queue_collapse", "depth": 6, "seconds": 0.2},
    {"kind": "data_stall", "seconds": 3.0},
    {"kind": "straggler", "delay_s": 1.5, "seconds": 0},
])
def test_listener_trips_what_jax_trips(tmp_path, rec):
    got = {}
    for pkg, (doc, ev) in DOCTORS.items():
        ev.enable(process_name=pkg, capacity=ev.DEFAULT_CAPACITY)
        engine = _Engine()
        _listener(doc, tmp_path / pkg, engine)._apply(dict(rec))
        stall = (tdataset if pkg == "torch" else jdataset)._STALL
        got[pkg] = (_bus_events(ev), vars(engine),
                    {k: v for k, v in stall.items()
                     if k != "per_batch_until"})
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0][1] == "fault/injected"


@pytest.mark.parametrize("kind", ["recompile_storm", "fabric_slow"])
def test_listener_kinds_without_a_counterpart_trip_nothing(tmp_path,
                                                           caplog, kind):
    """recompile_storm has no counterpart in the port and trips nothing;
    fabric_slow has one since the fabric health monitor was ported: it
    arms the monitor's throttle and touches no engine (its arguments are
    held to JAX's in tests/test_torch_telemetry_wiring.py)."""
    from container_engine_accelerators_tpu_torch.metrics import (
        fabric_health,
    )

    tevents.enable(process_name="torch", capacity=tevents.DEFAULT_CAPACITY)
    engine = _Engine()
    try:
        with caplog.at_level(logging.WARNING, logger=tdoctor.__name__):
            _listener(tdoctor, tmp_path, engine)._apply({"kind": kind,
                                                         "n": 4})
        names = [e[1] for e in _bus_events(tevents)]
        assert vars(engine) == {}
        if kind == "fabric_slow":
            assert names == ["fault/injected", "fabric/inject_slow"]
            assert fabric_health.injected_factor("dp", (0,)) == 8.0
        else:
            assert names == ["fault/injected"]
            assert any("trips nothing" in r.getMessage()
                       for r in caplog.records)
    finally:
        fabric_health.clear_injection()


def test_listener_health_tail_runs_the_real_pipeline(tmp_path):
    feed = tmp_path / "errors.jsonl"
    for _ in range(3):
        inject_fault.main(["--chip", "0", "--error-log", str(feed)])
    counts = {}
    for pkg, (doc, ev) in DOCTORS.items():
        ev.enable(process_name=pkg, capacity=ev.DEFAULT_CAPACITY)
        _listener(doc, tmp_path)._apply({
            "kind": "health_tail", "path": str(feed), "seconds": 0.3,
            "interval": 0.05})
        counts[pkg] = [e[1] for e in _bus_events(ev)]
    assert counts["torch"] == counts["jax"]
    assert counts["torch"].count("health/HBM_ECC_UNCORRECTABLE") == 3


def test_listener_tails_the_fault_log(tmp_path):
    """Through the file: a torn line waits for its newline, a malformed
    one is skipped, the next command still trips."""
    flog = tmp_path / "faults.jsonl"
    engine = _Engine()
    listener = tdoctor.FaultListener(str(flog), engine=engine,
                                     interval_s=0.02)
    listener.start()
    try:
        with open(flog, "a") as f:
            f.write("not json\n")
            f.write('{"kind": "worker_')
            f.flush()
            time.sleep(0.1)
            assert engine.fault_kill is False
            f.write('kill"}\n')
        deadline = time.monotonic() + 10
        while not engine.fault_kill and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.fault_kill is True
    finally:
        listener.stop()


# ---------------------------------------------------------------- card paths

def test_doctor_flags_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--tiny", "--doctor", "--fault-listen", "x.jsonl"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain_cli.main(["--doctor", "--steps", "1"])
    assert tdoctor.get_active() is None


def test_train_doctor_clean_run_is_quiet(tmp_path, capsys):
    assert ttrain_cli.main([
        "--device", "cpu", "--preset", "tiny", "--steps", "3",
        "--batch-size", "2", "--seq-len", "16", "--log-every", "1",
        "--heartbeat-dir", str(tmp_path / "hb"), "--doctor",
        "--doctor-dir", str(tmp_path / "inc")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["doctor_incidents"] == 0
    assert summary["final_step"] == 3
    assert not (tmp_path / "inc").exists() or not os.listdir(
        tmp_path / "inc")


# ---------------------------------------------------------------- engines

SMALL = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
SERVES = {"jax": (jserve, jrm, jevents), "torch": (tserve, trm, tevents)}
SCRIPT = [([1, 2, 3], 5), ([4, 5], 7), ([9, 8, 7, 6, 5, 4], 3),
          ([17] * 20, 6), ([2], 9)]
ENGINES = {
    "continuous": ("ContinuousEngine",
                   dict(max_slots=3, max_len=128, prefill_chunk=16)),
    "paged": ("PagedContinuousEngine",
              dict(max_slots=3, max_len=128, page=16, pool_pages=12,
                   prefill_chunk=16, prefix_cap=4)),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return {"jax": (params, jcfg), "torch": (model, tcfg)}


def _shape(x):
    """Keys all the way down; leaves become their type."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    return type(x).__name__


def _snapshot_run(pkg, kind, weights, monkeypatch):
    serve, rm, ev = SERVES[pkg]
    ev.enable(process_name=pkg, capacity=ev.DEFAULT_CAPACITY)
    cls_name, kw = ENGINES[kind]
    cls = getattr(serve, cls_name)
    gate = threading.Event()
    worker = cls._worker

    def gated(self):
        gate.wait(120)
        return worker(self)

    monkeypatch.setattr(cls, "_worker", gated)
    rec = rm.RequestRecorder()
    model, cfg = weights[pkg]
    eng = cls(model, cfg, recorder=rec, engine_core="sync", **kw)
    try:
        futs = [eng.submit(list(t), n, 0.0) for t, n in SCRIPT]
        queued = rec.state_snapshot()
        gate.set()
        for fut in futs:
            fut.result(timeout=120)
        deadline = time.monotonic() + 30
        while (rec.registry.get_sample_value("serve_active_slots") != 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        time.sleep(0.2)
        exp = rm.ServeMetricsExporter(rec, port=0, host="127.0.0.1")
        exp.state_provider = lambda: tserve.engine_state_snapshot(
            eng, rec, "r-test", kind)
        exp.start_background()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exp.bound_port}/debugz?n=0&state=1",
                    timeout=30) as resp:
                served = json.loads(resp.read())["state"]
        finally:
            exp.stop()
        return queued, rec.state_snapshot(), served
    finally:
        eng.stop()
        eng.thread.join(timeout=30)


def _counts(snap: dict) -> dict:
    keep = {k: snap[k] for k in ("queued", "slots", "kv_pages",
                                 "pool_depth")}
    keep["prefix_cache"] = {k: snap["prefix_cache"][k]
                            for k in ("lookups", "hits", "pages")}
    keep["slo_n"] = {k: snap["slo_windows"][k]["n"]
                     for k in ("ttft", "tpot")}
    for k in ("replica_id", "engine", "worker_alive", "worker_restarts",
              "requests_served", "batches_run", "prefill_workers",
              "prefill_workers_alive"):
        if k in snap:
            keep[k] = snap[k]
    return keep


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_state_snapshot_matches_jax(weights, monkeypatch, kind):
    got = {pkg: _snapshot_run(pkg, kind, weights, monkeypatch)
           for pkg in SERVES}
    for t_snap, j_snap in zip(got["torch"], got["jax"]):
        assert _shape(t_snap) == _shape(j_snap)
        assert _counts(t_snap) == _counts(j_snap)
    queued, after, served = got["torch"]
    assert queued["queued"] == len(SCRIPT)
    assert after["queued"] == 0 and after["slots"]["active"] == 0
    assert after["slo_windows"]["ttft"]["n"] == len(SCRIPT)
    assert served["replica_id"] == "r-test"
    assert served["requests_served"] == len(SCRIPT)
    assert served["worker_alive"] is True


def test_replica_stamp_matches_jax():
    stamps = {}
    for pkg, (_, ev) in DOCTORS.items():
        ev.set_replica_id("rA")
        ev.enable(process_name="serve")        # re-anchors the bus
        bus = ev.get_bus()
        chrome = bus.to_chrome()
        meta = [e["args"]["name"] for e in chrome["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"]
        stamps[pkg] = (bus.replica, bus.anchor.get("replica"),
                       sorted(bus.anchor), meta)
        ev.set_replica_id(None)
        assert "replica" not in bus.anchor
    assert stamps["torch"] == stamps["jax"]
    assert stamps["torch"][3][0].startswith("serve[rA] (")


# ---------------------------------------------------------------- live

def _wait_for(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_live_engine_hang_named_and_replayed_by_jax(weights, tmp_path):
    model, cfg = weights["torch"]
    engine = tserve.ContinuousEngine(model, cfg, max_slots=2, max_len=1024,
                                     prefill_chunk=0)
    rec = engine.recorder
    doc = listener = None
    try:
        engine.submit([1, 2, 3, 4], 4, 0.0).result(timeout=60)
        dump = str(tmp_path / "trace.json")
        tevents.enable(dump_path=dump, process_name="doctor-live",
                       capacity=tevents.DEFAULT_CAPACITY)
        live_cfg = dict(poll_interval_s=0.2, fast_window_s=8.0,
                        slow_window_s=40.0, hang_after_s=1.0,
                        clear_after_s=1e9)
        doc = tdoctor.Doctor(
            config=tdoctor.DoctorConfig(**live_cfg, slos=[]),
            registry=rec.registry, request_recorder=rec,
            out_dir=str(tmp_path / "incidents"))
        doc.start()
        flog = str(tmp_path / "faults.jsonl")
        listener = tdoctor.FaultListener(flog, engine=engine,
                                         interval_s=0.05)
        listener.start()

        # Clean phase: a request drains with no verdict.
        engine.submit([5, 6, 7], 8, 0.0).result(timeout=60)
        time.sleep(0.5)
        assert list(doc.incidents) == []

        stream: queue.Queue = queue.Queue()
        fut = engine.submit(list(range(1, 9)), 1000, 0.0, stream=stream)
        assert "token" in stream.get(timeout=60)
        assert inject_fault.main(["--kind", "hang", "--seconds", "2.5",
                                  "--fault-log", flog]) == 0
        assert _wait_for(lambda: [i["class"] for i in doc.incidents]
                         == ["engine_hang"], 20), list(doc.incidents)
        assert len(fut.result(timeout=120)) == 8 + 1000   # prompt + new
        doc.poll_once()
        live = list(doc.incidents)
        assert [(i["class"], i["subject"]) for i in live] == [
            ("engine_hang", "serve")]
        with open(live[0]["bundle_path"]) as f:
            assert json.load(f)["evidence"]["slots"]["active"] == 1
        tevents.dump_now()
        with open(dump) as f:
            trace = json.load(f)
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"fault/injected", "doctor/engine_hang"} <= names
        # The port's stream through the reference's detectors.
        replayed = {pkg: doc_mod.replay(
                        trace, config=doc_mod.DoctorConfig(**live_cfg,
                                                           slos=[]),
                        step_s=0.2)
                    for pkg, (doc_mod, _) in DOCTORS.items()}
        assert [(i["class"], i["subject"]) for i in replayed["jax"]] == [
            ("engine_hang", "serve")]
        assert_same_incidents(replayed["torch"], replayed["jax"])
    finally:
        if listener is not None:
            listener.stop()
        if doc is not None:
            doc.stop()
        engine.stop()
        engine.thread.join(timeout=30)
