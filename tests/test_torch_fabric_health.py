"""The port's fabric health plane (metrics/fabric_health.py) held against
the JAX package's on the CPU.

Each case of the JAX package's tests/test_fabric_health.py runs on both
monitors with the same fake `probe_fn`/`subgroup_probe_fn` (the JAX one
over a fake mesh of the axis sizes, the port's over fake process groups
of the same sizes): the probe-history rows, the gauges, the EventBus
events (name, category, arguments) and the snapshots must be equal,
timestamps aside, and the JAX test's own assertions hold on the port's.
The baseline JSON either package writes loads in the other; the port's
history rows are read by tools/fabric_report.load_rows; the port's live
events, dumped and replayed, fire the same fabric_degraded/fabric_flap
verdicts in both packages' doctors. Then four gloo ranks, each a process
of its own, sweep by step with inject_slow(rank=1) on every rank: each
localizes rank 1 through real subgroups. Tolerance: exact (the fakes are
deterministic), except the real-probe run, which checks only the named
rank."""

import json
import types

import pytest

from container_engine_accelerators_tpu.metrics import doctor as jdoctor
from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import fabric_health as jfh
from container_engine_accelerators_tpu_torch.metrics import doctor as tdoctor
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import (
    fabric_health as tfh,
)
from tests.test_torch_collectives import _run_ranks
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401
from tools import fabric_report

PKGS = {"jax": (jfh, jevents, jdoctor), "torch": (tfh, tevents, tdoctor)}


@pytest.fixture(autouse=True)
def clean_state():
    def reset():
        for fh, ev, doc in PKGS.values():
            ev._reset_for_tests()
            doc.set_active(None)
            fh.set_active(None)
            fh.clear_injection()
    reset()
    yield
    reset()


class FakeGroup:
    """What the port's monitor reads of a process group: its size."""

    def __init__(self, n: int, rank: int = 0):
        self._n, self._rank = n, rank

    def size(self) -> int:
        return self._n

    def rank(self) -> int:
        return self._rank


def make_monitor(pkg, bw=None, sub_calls=None, axis_n=4, **kw):
    """`pkg`'s monitor wired to fake probes, as the JAX test's
    make_monitor: `bw` maps axis -> busBW (mutable by the test),
    `sub_calls` collects the localization subgroup probes."""
    fh = PKGS[pkg][0]
    bw = bw if bw is not None else {"dp": 1e9}

    def probe_fn(axis, coll):
        return bw[axis]

    def subgroup_probe_fn(axis, ranks):
        if sub_calls is not None:
            sub_calls.append((axis, ranks))
        return 0.001

    kw.setdefault("axes", tuple(bw))
    if pkg == "jax":
        kw["mesh"] = types.SimpleNamespace(shape={a: axis_n for a in bw})
    else:
        kw["groups"] = {a: FakeGroup(axis_n) for a in bw}
    return fh.FabricHealthMonitor(probe_fn=probe_fn,
                                  subgroup_probe_fn=subgroup_probe_fn,
                                  min_samples=3, **kw), bw


def gauges(mon) -> dict:
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for metric in mon.registry.collect() for s in metric.samples
            if not s.name.endswith("_created")}


def gauge(mon, name, **labels):
    for (n, lab), v in gauges(mon).items():
        if n == name and all(dict(lab).get(k) == val
                             for k, val in labels.items()):
            return v
    return None


def untimed(rows) -> list:
    return [{k: v for k, v in r.items() if k != "t"} for r in rows]


def observables(mon, ev) -> dict:
    """What both packages must agree on: rows, gauges, events, snapshot
    (sweep_seconds is a wall time)."""
    g = {k: v for k, v in gauges(mon).items()
         if k[0] != "fabric_probe_sweep_seconds"}
    bus = [(e[0], e[3], e[4], e[7]) for e in ev.get_bus().snapshot()
           if e is not None]
    return {"rows": untimed(mon.history), "gauges": g, "events": bus,
            "snapshot": mon.snapshot()}


def both(scenario, bus: bool = False, **kw):
    """Run scenario(pkg, mon, bw, sub_calls) on each package's monitor
    (make_monitor(**kw), the bus on with `bus`); return {pkg: (the
    scenario's result, observables)} after checking that the observables
    are equal."""
    out = {}
    for pkg, (fh, ev, _) in PKGS.items():
        if bus:
            ev.enable(capacity=4096, process_name="fabric-test")
        sub_calls = []
        opts = dict(kw)
        if "bw" in opts:
            opts["bw"] = dict(opts["bw"])
        mon, bw = make_monitor(pkg, sub_calls=sub_calls, **opts)
        res = scenario(pkg, mon, bw, sub_calls)
        out[pkg] = (res, observables(mon, ev))
        fh.clear_injection()
        ev._reset_for_tests()
    assert out["torch"][1] == out["jax"][1]
    return out


def _inject(pkg, **kw):
    PKGS[pkg][0].inject_slow(**{"axis": "dp", "factor": 8.0,
                                "seconds": 60.0, "delay_s": 0.0, **kw})


# ---------- FabricBaselineStore ----------

@pytest.mark.parametrize("samples", [
    [100.0, 5.0], [100.0] * 6 + [10.0, 100.0],
    [100.0] * 5 + [92.0, 80.0], [1e9] * 4 + [1e8], [0.0] * 6 + [1.0, 0.0]])
def test_baseline_store_observes_as_jax(samples):
    """Maturity, the freeze during degradation, the relative floor and a
    zero center (ratio 1.0: the factor-0 collectives at n = 1)."""
    got, want = [], []
    for pkg, out in (("torch", got), ("jax", want)):
        st = PKGS[pkg][0].FabricBaselineStore(
            min_samples=3 if len(samples) != 7 else 2,
            rel_floor=0.05 if len(samples) != 7 else 0.10)
        out.extend(st.observe("k", v) for v in samples)
        out.append(st.to_json())
    assert got == want


def test_baseline_json_interchanges_with_jax(tmp_path):
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        st = PKGS[writer][0].FabricBaselineStore()
        for v in (1e9, 1.1e9, 0.9e9, 1e9):
            st.observe("all_reduce.dp.dcn", v)
        st.observe("ppermute.dp.ici", 5e8)
        path = str(tmp_path / f"{writer}.json")
        st.save(path)
        other = PKGS[reader][0].FabricBaselineStore()
        assert other.load(path)
        assert other.to_json() == st.to_json()
        # A seeded store is mature: a low first sample is degraded.
        assert other.observe("all_reduce.dp.dcn", 1e8)["degraded"]


def test_baseline_load_tolerates_garbage(tmp_path):
    st = tfh.FabricBaselineStore()
    assert not st.load(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert not st.load(str(bad))
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"kind": "perf_baseline"}))
    assert not st.load(str(wrong))
    assert st.entries == {}


# ---------- the monitor, on fake probes ----------

def test_sweep_updates_gauges_and_history():
    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            rows = mon.sweep_once()
        return untimed(rows)

    out = both(scenario)
    rows, obs = out["torch"]
    assert {r["collective"] for r in rows} == set(tfh.DEFAULT_COLLECTIVES)
    assert all(r["fabric"] == "ici" for r in rows)
    assert obs["snapshot"]["sweeps"] == 4
    assert len(obs["rows"]) == 4 * len(tfh.DEFAULT_COLLECTIVES)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_inject_slow_degrades_and_localizes(rank):
    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            mon.sweep_once()
        _inject(pkg, rank=rank)
        rows = untimed(mon.sweep_once())
        n_first = len(sub)
        mon.sweep_once()   # still degraded: no new localization pass
        return rows, n_first, len(sub), gauge(mon, "fabric_slow_rank",
                                              axis="dp")

    out = both(scenario, bus=True)
    (rows, n_first, n_after, slow), obs = out["torch"]
    assert all(r["degraded"] for r in rows)
    assert n_first > 0 and n_after == n_first
    assert slow == rank and obs["snapshot"]["slow_rank"] == rank
    assert obs["snapshot"]["score"] == pytest.approx(0.125)
    stamped = [r for r in rows if "slow_rank" in r]
    assert stamped and stamped[0]["slow_rank"] == rank
    deg = [e for e in obs["events"] if e[1] == "fabric/degraded"]
    assert len(deg) == 2 and deg[0][3]["slow_rank"] == rank
    assert [e[1] for e in obs["events"]].count("fabric/health") == 6
    assert [e[1] for e in obs["events"]].count("fabric/inject_slow") == 1


def test_recovery_clears_slow_rank_and_degraded():
    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            mon.sweep_once()
        _inject(pkg, rank=1)
        mon.sweep_once()
        before = mon.snapshot()["degraded"]
        PKGS[pkg][0].clear_injection()
        mon.sweep_once()
        return before

    out = both(scenario)
    before, obs = out["torch"]
    assert before == 1
    assert obs["snapshot"]["degraded"] == 0
    assert obs["snapshot"]["slow_rank"] is None


def test_poll_once_rate_limited_and_due_first_poll():
    def scenario(pkg, mon, bw, sub):
        counts = []
        for now, interval in ((100.0, None), (115.0, None), (130.0, None),
                              (134.0, 5.0), (160.0, None), (164.0, None),
                              (165.0, None)):
            if interval is not None:
                mon.interval = interval
            mon.poll_once(now=now)
            counts.append(mon.sweeps)
        return counts

    out = both(scenario, interval=30.0)
    assert out["torch"][0] == [1, 1, 2, 2, 3, 3, 4] == out["jax"][0]


def test_maybe_sweep_step_cadence():
    def scenario(pkg, mon, bw, sub):
        first = mon.maybe_sweep_step(3)   # train_every=0: disabled
        mon.train_every = 5
        return first, [s for s in range(1, 21) if mon.maybe_sweep_step(s)]

    out = both(scenario)
    assert out["torch"][0] == (False, [5, 10, 15, 20]) == out["jax"][0]


def test_observe_passive_shares_the_baseline_store():
    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            mon.observe_passive("dp", 2e9, collective="all_reduce",
                                fabric="dcn")
        return mon.baseline.observe("all_reduce.dp.dcn", 1e8)

    out = both(scenario)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["degraded"]
    assert out["torch"][1]["rows"][-1]["source"] == "passive"


def test_history_jsonl_rows_and_stamping(tmp_path):
    files = {}

    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            mon.sweep_once()
        _inject(pkg, rank=3)
        mon.sweep_once()
        with open(mon.history_path) as f:
            files[pkg] = [json.loads(line) for line in f]
        return None

    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
    out = {}
    for pkg in PKGS:
        mon, bw = make_monitor(pkg, history_path=str(
            tmp_path / pkg / "fabric-history.jsonl"))
        scenario(pkg, mon, bw, None)
        PKGS[pkg][0].clear_injection()
        out[pkg] = untimed(files[pkg])
    assert out["torch"] == out["jax"]
    rows = files["torch"]
    assert len(rows) == 5 * len(tfh.DEFAULT_COLLECTIVES)
    stamped = [r for r in rows if r["degraded"] and "slow_rank" in r]
    assert stamped and stamped[0]["slow_rank"] == 3
    # tools/fabric_report reads the port's rows as JAX's.
    loaded = fabric_report.load_rows([str(tmp_path / "torch" /
                                          "fabric-history.jsonl")])
    assert untimed(loaded) == out["jax"]
    report = fabric_report.build_report(loaded)
    assert report["degraded_axes"] == ["dp"]
    assert report["episodes"][0]["slow_rank"] == 3


def test_snapshot_names_worst_axis():
    def scenario(pkg, mon, bw, sub):
        for _ in range(4):
            mon.sweep_once()
        bw["fsdp"] = 1e8
        mon.sweep_once()
        return mon.snapshot()

    out = both(scenario, bw={"dp": 1e9, "fsdp": 1e9})
    snap = out["torch"][0]
    assert snap["worst_axis"] == "fsdp" and snap["degraded"] == 1
    assert snap["score"] == pytest.approx(0.1, rel=0.05)


def test_monitor_seeds_from_committed_baseline(tmp_path):
    """A baseline either package saved seeds the other's monitor: the
    first sweep under injection votes degraded."""
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        path = str(tmp_path / f"{writer}-FABRIC_BASELINE.json")
        mon, _ = make_monitor(writer, baseline_path=path)
        for _ in range(4):
            mon.sweep_once()
        mon.save_baseline()
        mon2, _ = make_monitor(reader, baseline_path=path)
        _inject(reader, rank=0)
        assert all(r["degraded"] for r in mon2.sweep_once())
        PKGS[reader][0].clear_injection()


def test_injection_is_scoped_to_axis_rank_and_window(monkeypatch):
    for pkg in PKGS:
        fh = PKGS[pkg][0]
        fh.inject_slow(axis="dp", rank=2, factor=0.5, seconds=10.0,
                       delay_s=-1.0)
        assert fh.injected_factor("dp") == 1.0       # floored at 1
        assert fh.injection_delay("dp") == 0.0       # floored at 0
        fh.inject_slow(axis="dp", rank=2, factor=8.0, seconds=10.0)
        got = (fh.injected_factor("dp", (0, 1)), fh.injected_factor(
            "dp", (2, 3)), fh.injected_factor("tp"), fh.injection_delay(
            "dp", (2,)))
        assert got == (1.0, 8.0, 1.0, 0.02), pkg
        real = fh.time.monotonic
        monkeypatch.setattr(fh.time, "monotonic", lambda: real() + 11.0)
        assert fh.injected_factor("dp") == 1.0
        monkeypatch.undo()
        fh.clear_injection()


# ---------- the doctor on the port's live events ----------

def _replay_classes(doc, trace, cfg_kw) -> list:
    cfg = doc.DoctorConfig(poll_interval_s=1.0, fast_window_s=10.0,
                           slow_window_s=50.0, clear_after_s=5.0, slos=[],
                           fabric_degraded_n=3, fabric_flap_n=4, **cfg_kw)
    return [(i["class"], i["subject"], i["evidence"].get("slow_rank"))
            for i in doc.replay(trace, config=cfg)]


@pytest.mark.parametrize("pattern", ["degraded", "flap"])
def test_live_port_events_fire_the_same_verdicts(pattern, monkeypatch):
    """The port's monitor sweeps (fake probes, a stepped clock) with the
    bus on; its dump, replayed by each package's doctor, gives the same
    fabric verdicts."""
    clock = [1000.0]
    monkeypatch.setattr(tevents.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(tfh.time, "monotonic", lambda: clock[0])
    bus = tevents.enable(capacity=1 << 14, process_name="serve")
    mon, bw = make_monitor("torch")
    phases = ([(False, 6), (True, 6), (False, 2)] if pattern == "degraded"
              else [(False, 6)] + [(i % 2 == 1, 1) for i in range(10)])
    for slow, n in phases:
        if slow:
            tfh.inject_slow(axis="dp", rank=1, factor=8.0, seconds=1e6,
                            delay_s=0.0)
        else:
            tfh.clear_injection()
        for _ in range(n):
            mon.sweep_once()
            clock[0] += 1.0
    trace = bus.to_chrome()
    got = _replay_classes(tdoctor, trace, {})
    want = _replay_classes(jdoctor, trace, {})
    assert got == want
    classes = [c for c, _, _ in got]
    if pattern == "degraded":
        assert ("fabric_degraded", "dp", 1) in got
        assert "fabric_flap" not in classes
    else:
        assert "fabric_flap" in classes


# ---------- four gloo ranks sweeping in step lockstep ----------

SWEEP_RANK = r"""
import json, sys
import torch.distributed as dist
from container_engine_accelerators_tpu_torch.metrics import fabric_health
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mon = fabric_health.FabricHealthMonitor(
    groups={"dp": dist.group.WORLD}, size_bytes=1 << 12, warmup=1, iters=2,
    min_samples=3)
# Real gloo probes on a loaded test host jitter by several times: only a
# sweep below 2% of the baseline is degraded (the fault, a 0.2 s sleep
# in a ~1 ms probe and the factor 8, reads ~1000x slower).
mon.baseline.rel_floor = 0.98
mon.train_every = 1
snaps = []
for step in range(1, 7):
    if step == 6:   # the fault command reaches every rank
        fabric_health.inject_slow(axis="dp", rank=1, factor=8.0,
                                  seconds=600.0, delay_s=0.2)
    mon.maybe_sweep_step(step)
    snaps.append(mon.snapshot())
subgroups = sorted(str(k[1]) for k in mon._built_sub)
dist.destroy_process_group()
with open(sys.argv[4], "w") as f:
    json.dump({"snaps": snaps, "subgroups": subgroups}, f)
"""


def test_four_gloo_ranks_localize_rank_one_by_step(two_torch_threads):
    ranks = _run_ranks(SWEEP_RANK, 4)
    for r, out in enumerate(ranks):
        snaps = out["snaps"]
        assert [s["degraded"] for s in snaps[:5]] == [0] * 5, r
        assert snaps[5]["degraded"] == 1 and snaps[5]["slow_rank"] == 1, r
        assert snaps[5]["axes"]["dp"]["fabric"] == "ici"
        # Every rank built the same subgroups, in the same order.
        assert out["subgroups"] == ranks[0]["subgroups"]
    assert ranks[0]["subgroups"] == ["(0, 1)", "(0,)", "(1,)", "(2, 3)"]
