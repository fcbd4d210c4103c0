"""The port's fleet plane (metrics/fleet.py, cli/fleetmon.py, cli/fleet.py)
held against the JAX package's on the CPU: parse_metrics_text on whole
and torn bodies, FleetState's transitions and rollups on one synthetic
clock driven into both, the three fleet detectors (replica_down,
fleet_imbalance, fleet_slo_burn) through `doctor.replay` of both on
timelines jittered from a numpy seed, the scrapers of both packages
polling two in-process port exporters, the fleet exporter's families
(names, labels and help) and both CLIs' flags. The subprocess fleet (two
`--tiny` replicas, loadgen fanned over both, fleetmon with the doctor,
one replica SIGKILLed) carries `slow`, as the JAX package's does.
Tolerance: exact, except confidence (1e-9)."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.cli import fleet as jfleet_cli
from container_engine_accelerators_tpu.cli import fleetmon as jfleetmon
from container_engine_accelerators_tpu.metrics import doctor as jdoctor
from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import fleet as jfleet
from container_engine_accelerators_tpu_torch.cli import fleet as tfleet_cli
from container_engine_accelerators_tpu_torch.cli import fleetmon as tfleetmon
from container_engine_accelerators_tpu_torch.cli import loadgen as tloadgen
from container_engine_accelerators_tpu_torch.metrics import doctor as tdoctor
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import fleet as tfleet
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)

REPO = Path(__file__).resolve().parents[1]
SEED = 150
FLEETS = {"jax": (jfleet, jdoctor, jevents),
          "torch": (tfleet, tdoctor, tevents)}
VOLATILE = ("t", "pid", "bundle_path")
# The one help string that differs: the JAX package's names the change
# history of the host-gap gauge; the port's names the gauge itself.
HOSTGAP = "fleet_replica_host_gap_fraction"


@pytest.fixture(autouse=True)
def clean():
    for _, doc, ev in FLEETS.values():
        ev._reset_for_tests()
        doc.set_active(None)
    yield
    for _, doc, ev in FLEETS.values():
        ev._reset_for_tests()
        doc.set_active(None)


# ---------------------------------------------------------------- parsing

BODIES = [
    "# HELP serve_queue_depth q\n# TYPE serve_queue_depth gauge\n"
    "serve_queue_depth 3.0\nserve_requests_total{outcome=\"ok\"} 7.0\n"
    "serve_kv_pages_in_use 5.0\nbogus notanumber\n",
    "serve_queue_depth 0.0\nserve_prefix_lookups_total 4.0\n",
    "",                                               # empty
    "serve_queue_depth 3.0\nserve_kv_pa",             # cut mid-line
    "some_other_family 1.0\n",                        # half-initialized
]


@pytest.mark.parametrize("body", BODIES)
def test_parse_metrics_text_matches_jax(body):
    got = {}
    for pkg, (fleet, _, _) in FLEETS.items():
        try:
            got[pkg] = fleet.parse_metrics_text(
                body, required=fleet.DEFAULT_REQUIRED_FAMILIES)
        except fleet.ScrapeError as e:
            got[pkg] = ("ScrapeError", str(e))
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------- state

def _drive(fleet) -> list:
    """One scripted sequence of scrapes on a synthetic clock; every
    transition, rollup and table along the way."""
    rng = np.random.default_rng(SEED)
    st = fleet.FleetState(down_after_s=2.0)
    out = []
    t = 0.0
    for k in range(12):
        t += float(rng.uniform(0.4, 0.6))
        snap = {"queued": int(rng.integers(0, 6)),
                "slots": {"active": int(rng.integers(0, 3)), "total": 4},
                "kv_pages": {"used": int(rng.integers(0, 9)), "total": 16},
                "prefix_cache": {"lookups": 10 + k, "hits": k},
                "slo_windows": {"ttft": {"n": k, "bad": k // 3},
                                "tpot": {"n": 5 * k, "bad": k // 4}},
                "kv_thermal": {"buckets": {"cold": k % 4},
                               "working_set_pages": 3},
                "worker_alive": True, "requests_served": 2 * k}
        out.append(st.observe_ok("rA", "uA", snap,
                                 {"serve_queue_depth": 1.0}, now=t))
        if k < 4 or k > 9:
            out.append(st.observe_ok("rB", "uB", {"queued": 1},
                                     {"serve_host_gap_fraction": 0.5},
                                     now=t))
        else:                                     # rB stale, then down
            out.append(st.observe_failure("rB", "uB", "refused", now=t))
        out.append(st.aggregates(now=t))
        out.append(st.debugz(now=t))
        out.append([r.series_values() for r in st.replicas()])
    st.remove("rB")
    out.append((st.version, [r.rid for r in st.replicas()]))
    return out


def test_fleet_state_transitions_match_jax():
    ours, theirs = _drive(tfleet), _drive(jfleet)
    assert ours == theirs
    states = [x for x in ours if isinstance(x, tuple) and len(x) == 2
              and isinstance(x[0], str)]
    assert ("stale", "down") in states and ("down", "up") in states


# ---------------------------------------------------------------- detectors

def _timeline(seed, build) -> dict:
    rng = np.random.default_rng(seed)
    evs = []

    def counter(name, t, **vals):
        evs.append({"name": name, "cat": "fleet", "ph": "C", "pid": 1,
                    "tid": 1, "args": vals,
                    "ts": round((100.0 + t + float(rng.uniform(0, 0.02)))
                                * 1e6, 3)})

    def instant(name, t, **args):
        evs.append({"name": name, "cat": "fleet", "ph": "i", "pid": 1,
                    "tid": 1, "args": args, "s": "t",
                    "ts": round((100.0 + t) * 1e6, 3)})

    build(counter, instant, rng)
    return {"traceEvents": evs}


def _sample(level, queued=0.0, requests=0.0, kv_free=8.0, kv_total=8.0):
    return dict(state=level, queued=queued, active=min(queued, 2.0),
                kv_free=kv_free, kv_total=kv_total, requests=requests,
                restarts=0.0, worker_alive=1.0 if level == 2 else 0.0)


def _replica_down(counter, instant, rng):
    for k in range(16):
        t = 0.25 * k
        counter("fleet/replica/rA", t, **_sample(2, requests=k))
        level = 2 if k < 6 else (1 if k < 10 else 0)
        counter("fleet/replica/rB", t,
                **_sample(level, queued=float(rng.integers(1, 4)),
                          requests=3.0))
        if level < 2:
            instant("fleet/scrape_error", t, replica="rB",
                    error="URLError: <urlopen error [Errno 111] refused>")
    counter("fleet/replicas", 4.0, up=1, stale=0, down=1)


def _fleet_imbalance(counter, instant, rng):
    for k in range(8):
        t = 0.5 * k
        counter("fleet/replica/rA", t,
                **_sample(2, queued=float(rng.integers(10, 13)),
                          kv_free=1.0, kv_total=16.0))
        counter("fleet/replica/rB", t,
                **_sample(2, queued=float(rng.integers(0, 2)),
                          kv_free=15.0, kv_total=16.0))


def _fleet_slo_burn(counter, instant, rng):
    for k in range(8):
        n = 30 + k
        counter("fleet/slo_ttft", 0.5 * k, n=n,
                bad=int(n * float(rng.uniform(0.5, 0.8))))
        counter("fleet/slo_tpot", 0.5 * k, n=10 * n, bad=0)


FLEET_SCENARIOS = {"replica_down": _replica_down,
                   "fleet_imbalance": _fleet_imbalance,
                   "fleet_slo_burn": _fleet_slo_burn}


def _config(doctor):
    return doctor.DoctorConfig(
        poll_interval_s=0.5, fast_window_s=10.0, slow_window_s=50.0,
        clear_after_s=1e9, fleet_imbalance_queue=3.0,
        fleet_imbalance_min_samples=3,
        slos=[doctor.SloSpec("ttft_p99", "ttft", threshold_s=2.0,
                             objective=0.9, min_samples=20, fast_burn=2.0,
                             slow_burn=1.0)])


def _stable(incs):
    return [{k: v for k, v in i.items() if k not in VOLATILE}
            for i in incs]


@pytest.mark.parametrize("cls", sorted(FLEET_SCENARIOS))
def test_fleet_detectors_match_jax(cls):
    trace = _timeline(SEED + len(cls), FLEET_SCENARIOS[cls])
    got = {pkg: doc.replay(trace, config=_config(doc))
           for pkg, (_, doc, _) in FLEETS.items()}
    ours, theirs = _stable(got["torch"]), _stable(got["jax"])
    assert [i.pop("confidence") for i in ours] == pytest.approx(
        [i.pop("confidence") for i in theirs], abs=1e-9)
    assert ours == theirs
    assert [i["class"] for i in ours] == [cls]
    if cls == "replica_down":
        assert ours[0]["subject"] == "rB"


def test_fleet_registry_slice_is_jax_slice():
    assert ([d.cls for d in tfleet.fleet_detectors()]
            == [d.cls for d in jfleet.fleet_detectors()])
    assert ([d.cls for d in tdoctor.default_detectors()][-3:]
            == ["replica_down", "fleet_imbalance", "fleet_slo_burn"])


# ---------------------------------------------------------------- scraping

def _port_replica(queued: int, state: dict | None):
    """A port ServeMetricsExporter on an ephemeral port over a plain port
    RequestRecorder (the wire contract fleetmon reads, minus the engine),
    optionally with a state provider."""
    rec = trm.RequestRecorder()
    for i in range(queued):
        rec.enqueue(f"stub-{i}")
    rec.set_kv_pages(3, 9)
    exp = trm.ServeMetricsExporter(rec, port=0, host="127.0.0.1",
                                   interval=0.1)
    if state is not None:
        exp.state_provider = lambda: {**rec.state_snapshot(), **state}
    exp.start_background()
    return exp, f"http://127.0.0.1:{exp.bound_port}"


def test_scrapers_of_both_packages_read_port_replicas_alike():
    exp_a, url_a = _port_replica(4, {"worker_alive": True,
                                     "requests_served": 3})
    exp_b, url_b = _port_replica(2, None)     # /metrics fallback only
    try:
        aggs = {}
        for pkg, (fleet, _, ev) in FLEETS.items():
            ev.enable(process_name=pkg, capacity=ev.DEFAULT_CAPACITY)
            sc = fleet.FleetScraper([url_a, url_b],
                                    replica_ids=["rA", "rB"],
                                    timeout_s=10.0, down_after_s=5.0)
            agg = sc.poll_once(now=0.0)
            counters = [(e["name"], e.get("args"))
                        for e in ev.get_bus().to_chrome()["traceEvents"]
                        if e["ph"] == "C"]
            aggs[pkg] = (agg, sc.last_outcomes, counters)
        assert aggs["torch"] == aggs["jax"]
        agg = aggs["torch"][0]
        assert agg["replicas"] == {"up": 2, "stale": 0, "down": 0}
        assert agg["queue_depth"] == 6.0
        assert agg["kv_headroom_pages"] == 12.0
        assert agg["slo"]["ttft"] == {"n": 0, "bad": 0}
        exp_b.stop()                          # rB dies between polls
        sc = tfleet.FleetScraper([url_a, url_b], replica_ids=["rA", "rB"],
                                 timeout_s=2.0, down_after_s=5.0)
        sc.poll_once(now=0.0)
        assert sc.poll_once(now=10.0)["replicas"] == {
            "up": 1, "stale": 0, "down": 1}
    finally:
        exp_a.stop()
        exp_b.stop()


def _families(registry) -> dict:
    return {c._name: (c._type, tuple(c._labelnames), c._documentation)
            for c in registry._collector_to_names}


def test_fleet_exporter_families_match_jax():
    fams = {}
    for pkg, (fleet, _, _) in FLEETS.items():
        sc = fleet.FleetScraper(["http://127.0.0.1:9"], replica_ids=["rX"])
        fams[pkg] = _families(fleet.FleetExporter(
            sc, registry=CollectorRegistry()).registry)
    ours, theirs = fams["torch"], fams["jax"]
    assert ours[HOSTGAP][:2] == theirs[HOSTGAP][:2]
    assert ours[HOSTGAP][2] == (
        "Per-replica exposed-host fraction (the serve_host_gap_fraction "
        "gauge, mirrored fleet-wide)")
    assert ({k: v for k, v in ours.items() if k != HOSTGAP}
            == {k: v for k, v in theirs.items() if k != HOSTGAP})
    assert len(ours) == 19


def test_fleet_exporter_serves_the_rollup_and_its_table():
    exp_a, url_a = _port_replica(1, {"worker_alive": True})
    try:
        texts = {}
        for pkg, (fleet, _, _) in FLEETS.items():
            sc = fleet.FleetScraper([url_a], replica_ids=["rA"],
                                    timeout_s=10.0)
            fx = fleet.FleetExporter(sc, port=0, host="127.0.0.1",
                                     interval=30.0)
            fx.poll_once()
            fx.start_background()
            try:
                base = f"http://127.0.0.1:{fx.bound_port}"
                # The poll thread scrapes once as it starts: read after
                # that second scrape, so that both packages' texts count
                # two however the host schedules the thread.
                deadline = time.monotonic() + 10
                while True:
                    with urllib.request.urlopen(base + "/metrics",
                                                timeout=10) as r:
                        text = r.read().decode()
                    if any(line.startswith("fleet_scrapes_total")
                           and line.endswith(" 2.0")
                           for line in text.splitlines()) \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
                with urllib.request.urlopen(base + "/debugz?n=0&state=1",
                                            timeout=10) as r:
                    table = json.loads(r.read())["state"]
            finally:
                fx.stop()
            texts[pkg] = (sorted(line for line in text.splitlines()
                                 if line.startswith("fleet_")
                                 and "staleness" not in line
                                 and "_created" not in line),
                          [{k: v for k, v in row.items()
                            if k not in ("staleness_s", "snapshot")}
                           for row in table["replicas"]])
        assert texts["torch"] == texts["jax"]
        assert 'fleet_replicas{state="up"} 1.0' in texts["torch"][0]
        assert texts["torch"][1][0]["state"] == "up"
    finally:
        exp_a.stop()


# ---------------------------------------------------------------- CLIs

def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     a.required) for a in parser._actions
            if a.dest != "help"}


def test_fleetmon_flags_are_jax_flags():
    assert _options(tfleetmon.make_parser()) == _options(
        jfleetmon.make_parser())


def test_fleet_launcher_flags_and_forwarding_match_jax():
    ours = _options(tfleet_cli.make_parser())
    assert ours.pop("keep_survivors") == (("--keep-survivors",), False,
                                          None, False)
    assert ours == _options(jfleet_cli.make_parser())
    extra = ["--engine", "paged", "--trace-dump", "/tmp/x",
             "--fault-listen", "/tmp/f.jsonl", "--checkpoint", "/ckpt"]
    assert (tfleet_cli._suffix_path_args(extra, "r1")
            == jfleet_cli._suffix_path_args(extra, "r1"))
    assert tfleet_cli.SERVE_MOD.endswith("_torch.cli.serve")


# ---------------------------------------------------------------- e2e

def _json_line(stream, kind, deadline_s=240.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        line = stream.readline()
        if not line:
            time.sleep(0.1)
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("kind") == kind:
            return rec
    raise AssertionError(f"no {kind!r} line within {deadline_s}s")


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


@pytest.mark.slow
def test_fleet_e2e_two_replicas_replica_kill(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    try:
        fl = subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cli.fleet",
             "--replicas", "2", "--ready-timeout", "240",
             "--keep-survivors", "--", "--device", "cpu", "--engine",
             "paged", "--max-len", "512", "--trace-dump",
             str(tmp_path / "tr")],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, text=True)
        procs.append(fl)
        reps = {r["id"]: r for r in _json_line(fl.stdout,
                                               "fleet")["replicas"]}
        assert set(reps) == {"r0", "r1"}
        for rep in reps.values():
            assert json.loads(_get(rep["url"] + "/healthz"))[
                "replica_id"] == rep["id"]
        fm = subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cli.fleetmon",
             "--endpoints", ",".join(reps[r]["metrics_url"]
                                     for r in ("r0", "r1")),
             "--replica-ids", "r0,r1", "--interval", "0.25",
             "--down-after", "1.0", "--doctor", "--doctor-interval", "0.5",
             "--doctor-dir", str(tmp_path / "inc"),
             "--trace-dump", str(tmp_path / "fleetmon.json")],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, text=True)
        procs.append(fm)
        base = f"http://127.0.0.1:{_json_line(fm.stdout, 'fleetmon')['port']}"
        args = tloadgen.make_parser().parse_args([
            "--targets", ",".join(reps[r]["url"] for r in ("r0", "r1")),
            "--requests", "4", "--concurrency", "2", "--max-new-tokens",
            "4", "--prompt-len", "4", "--timeout", "300"])
        summary, rc = tloadgen.run(args)
        assert rc == 0 and summary["requests_ok"] == 4, summary
        time.sleep(1.0)
        os.kill(reps["r1"]["pid"], signal.SIGKILL)
        deadline = time.monotonic() + 60
        while 'fleet_replicas{state="down"} 1.0' not in _get(
                base + "/metrics"):
            assert time.monotonic() < deadline
            time.sleep(0.3)
        deadline = time.monotonic() + 60
        while True:
            verdicts = json.loads(_get(base + "/debugz?n=0&doctor=1"))[
                "doctor"]["incidents"]
            if verdicts or time.monotonic() > deadline:
                break
            time.sleep(0.3)
        assert [(v["class"], v["subject"]) for v in verdicts] == [
            ("replica_down", "r1")]
        assert json.loads(_get(reps["r0"]["url"] + "/healthz"))["ok"]
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
