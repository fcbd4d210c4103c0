"""Fabric health plane: learned busBW baselines, degradation verdicts
and slow-rank localization; the JAX package's `metrics/fabric_health.py`
over torch.distributed process groups.

The observability triad of the reference repo is nccl-tests (active
collective probes), the fabric-metrics DaemonSet (passive NIC and link
counters) and node-problem-detector (the verdict that NAMES the bad
node). `ops/collectives.py` and `metrics/fabric.py` cover the first two;
this module is the third: a `FabricHealthMonitor` that

  - runs scheduled low-rate probe sweeps over every axis x
    {all_reduce, all_gather, ppermute}, with the `probe_collective`
    timing discipline and probes built once per (axis, collective);
  - keeps per-(collective, axis, fabric) rolling baselines (EWMA center
    + EWMA absolute-deviation spread), persisted to a
    `FABRIC_BASELINE.json` that either package reads;
  - exports `fabric_probe_busbw_bytes_per_second`,
    `fabric_health_score{axis}` and `fabric_degraded{axis}` gauges plus
    `fabric/health` counter samples and `fabric/degraded` EventBus
    instants for the doctor;
  - on a healthy->degraded transition, names the slowest rank by
    ppermute probes over bisected subgroups of the axis. A subgroup
    probe is a ring send confined to its ranks followed by a barrier
    over the whole axis, so every rank's wall time includes the slowest
    member and the bisection's decisions agree across processes;
  - takes passive busBW samples (`observe_passive`) into the same store.

Where JAX takes a Mesh and an axis name, the monitor takes
`groups={axis: process group}`; by default one `dp` group, the
process's (parallel/distributed.default_group: the job's, or one rank
on this card). A torch rank is one process, so a job of several ranks
sweeps in step lockstep from its training loop (`maybe_sweep_step`),
never on independent timers: the probes are matched collectives.
`dist.new_group` is itself a collective call, so every rank builds every
bisection subgroup, in the same order, members or not, and keeps it
(`_built_sub`).

One card (n = 1). With nccl-tests' factors all_reduce and all_gather
read busBW 0 at n = 1, and only ppermute (factor 1, a copy through the
group) moves bytes. Their baselines sit at 0 and FabricBaselineStore
gives a zero center the ratio 1.0, so on one card the health score is
ppermute's, as it is on one chip in the JAX package.

Degraded samples do NOT update the baseline (the center must not chase
a fault down); they are compared against the last healthy center minus
`spread_mult` spreads (with a relative floor so a near-zero learned
spread is not a hair trigger).

Chaos hook: `inject_slow()` throttles the probe path: a real sleep
inside the timed window (so in a job of several ranks EVERY rank
measures the slowdown, as with a genuinely slow peer) plus a
deterministic factor on the measured time. The fault listener maps
`inject_fault --kind fabric-slow` here.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

from prometheus_client import CollectorRegistry, Counter, Gauge

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.metrics.serving import (
    ExporterBase,
)

log = logging.getLogger(__name__)

DEFAULT_COLLECTIVES = ("all_reduce", "all_gather", "ppermute")
BASELINE_KIND = "fabric_baseline"
BASELINE_VERSION = 1
PROBE_ROW_KIND = "fabric_probe"

# ---------- active-monitor registry ----------
#
# Like doctor.set_active: lets the training loop (training/train.py)
# drive step-synchronized sweeps without threading the monitor through
# fit()'s signature. A job of several ranks MUST drive sweeps from the
# step loop, not a wall-clock thread: the probes are matched
# collectives, and ranks sweeping on independent timers would deadlock.

_ACTIVE_LOCK = threading.Lock()
_ACTIVE = None


def set_active(monitor) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = monitor


def get_active():
    with _ACTIVE_LOCK:
        return _ACTIVE


# ---------- fault injection (inject_fault --kind fabric-slow) ----------

_INJECT_LOCK = threading.Lock()
_INJECT: dict | None = None


def inject_slow(axis: str = "dp", rank: int = 0, factor: float = 8.0,
                seconds: float = 60.0, delay_s: float = 0.02) -> None:
    """Throttle the probe path for `seconds`: probes over `axis` whose
    subgroup contains `rank` sleep `delay_s` inside the timed window
    and have their measured time scaled by `factor`. The sleep is the
    multi-process-honest part (a matched collective drags every
    participant); the factor keeps single-process tests deterministic."""
    global _INJECT
    with _INJECT_LOCK:
        _INJECT = {"axis": axis, "rank": int(rank),
                   "factor": max(float(factor), 1.0),
                   "delay_s": max(float(delay_s), 0.0),
                   "until": time.monotonic() + float(seconds)}
    if events.enabled():
        events.instant("fabric/inject_slow", "chaos",
                       {"axis": axis, "rank": int(rank),
                        "factor": float(factor),
                        "seconds": float(seconds)})
    log.warning("fabric-slow injected: axis=%s rank=%d factor=%.1f "
                "for %.1fs", axis, rank, factor, seconds)


def clear_injection() -> None:
    global _INJECT
    with _INJECT_LOCK:
        _INJECT = None


def _active_injection(axis: str, ranks=None) -> dict | None:
    with _INJECT_LOCK:
        inj = _INJECT
    if inj is None or inj["axis"] != axis:
        return None
    if time.monotonic() >= inj["until"]:
        return None
    if ranks is not None and inj["rank"] not in ranks:
        return None
    return inj


def injected_factor(axis: str, ranks=None) -> float:
    inj = _active_injection(axis, ranks)
    return inj["factor"] if inj is not None else 1.0


def injection_delay(axis: str, ranks=None) -> float:
    inj = _active_injection(axis, ranks)
    return inj["delay_s"] if inj is not None else 0.0


# ---------- rolling baseline store ----------

class FabricBaselineStore:
    """Per-key EWMA center + EWMA absolute-deviation spread, the
    PERF_BASELINE.json idea applied to busBW: a committed JSON file
    records what healthy looked like, and a live sample is degraded
    when it falls below center - spread_mult * spread. Out-of-band
    samples freeze the baseline (a fault must not be learned as the
    new normal)."""

    def __init__(self, alpha: float = 0.2, spread_mult: float = 3.0,
                 min_samples: int = 3, rel_floor: float = 0.05):
        self.alpha = alpha
        self.spread_mult = spread_mult
        self.min_samples = min_samples
        self.rel_floor = rel_floor
        self.entries: dict[str, dict] = {}
        self._lock = threading.Lock()

    def observe(self, key: str, value: float,
                source: str = "probe") -> dict:
        """Fold one busBW sample into the baseline for `key`
        ("<collective>.<axis>.<fabric>"); returns
        {center, spread, n, degraded, ratio}."""
        value = float(value)
        with self._lock:
            ent = self.entries.get(key)
            if ent is None:
                self.entries[key] = {"center": value, "spread": 0.0,
                                     "n": 1}
                return {"center": value, "spread": 0.0, "n": 1,
                        "degraded": False, "ratio": 1.0,
                        "source": source}
            center, spread, n = ent["center"], ent["spread"], ent["n"]
            band = max(self.spread_mult * spread,
                       self.rel_floor * center)
            mature = n >= self.min_samples
            degraded = bool(mature and value < center - band)
            ratio = value / center if center > 0 else 1.0
            if not degraded:
                a = self.alpha if mature else max(self.alpha, 1.0 / (n + 1))
                center += a * (value - center)
                spread = (1 - a) * spread + a * abs(value - center)
                ent.update(center=center, spread=spread, n=n + 1)
            return {"center": ent["center"], "spread": ent["spread"],
                    "n": ent["n"], "degraded": degraded,
                    "ratio": ratio, "source": source}

    def get(self, key: str) -> dict | None:
        with self._lock:
            ent = self.entries.get(key)
            return dict(ent) if ent is not None else None

    # ---- persistence (FABRIC_BASELINE.json) ----

    def to_json(self) -> dict:
        with self._lock:
            entries = {k: {"center": round(v["center"], 3),
                           "spread": round(v["spread"], 3),
                           "n": v["n"]}
                       for k, v in self.entries.items()}
        return {"kind": BASELINE_KIND, "version": BASELINE_VERSION,
                "unit": "bytes_per_second", "alpha": self.alpha,
                "spread_mult": self.spread_mult,
                "min_samples": self.min_samples,
                "entries": entries}

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        """Seed entries from a committed baseline; missing or
        malformed files are ignored (the store just relearns)."""
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, ValueError):
            return False
        if obj.get("kind") != BASELINE_KIND:
            return False
        with self._lock:
            for key, ent in obj.get("entries", {}).items():
                try:
                    self.entries[key] = {
                        "center": float(ent["center"]),
                        "spread": float(ent["spread"]),
                        "n": int(ent["n"])}
                except (KeyError, TypeError, ValueError):
                    continue
        return True


# ---------- the monitor ----------

class FabricHealthMonitor(ExporterBase):
    """Scheduled probe sweeps + baselines + degradation verdicts.

    Runs standalone on its own port (`start_background()`), or pass
    another exporter's `registry=` to co-serve the gauges and drive
    `poll_once()` from its loop; either way the sweep cadence is
    rate-limited by `interval` (due on the first poll).

    `groups` maps each axis name to its process group (an object with
    size() and rank(), which is all the fake-probe tests give); None
    builds one `dp` group, the process's (default_group over `backend`:
    nccl on the card, gloo on the CPU, on `device`), when a probe first
    needs it. `probe_fn(axis, collective) -> busbw_bytes_per_second` and
    `subgroup_probe_fn(axis, ranks) -> seconds` replace the real
    collective path for tests; injection still applies to both.

    `sweep_lock`, where given, is held around each sweep. A server on
    one card passes its engine's lock: the probes then never overlap a
    tick on the card or in the interpreter, which would read as a slow
    fabric (a sweep of 64 MiB probes pauses the engine for a few
    milliseconds)."""

    name = "fabric-health"

    def __init__(self, groups=None, axes=None,
                 collectives=DEFAULT_COLLECTIVES,
                 size_bytes: int = 1 << 16, warmup: int = 1,
                 iters: int = 2, interval: float = 30.0,
                 port: int = 0,
                 baseline_path: str | None = None,
                 alpha: float = 0.2, spread_mult: float = 3.0,
                 min_samples: int = 3,
                 registry: CollectorRegistry | None = None,
                 probe_fn=None, subgroup_probe_fn=None,
                 localize: bool = True,
                 history_path: str | None = None,
                 history_cap: int = 4096,
                 backend: str = "nccl", device=None, sweep_lock=None):
        self._groups = dict(groups) if groups is not None else None
        self._axes = tuple(axes) if axes is not None else None
        self.backend = backend
        self.device = device
        self._sweep_lock = sweep_lock
        self.group_start: dict | None = None
        self.collectives = tuple(collectives)
        self.size_bytes = size_bytes
        self.warmup = warmup
        self.iters = iters
        self.interval = interval
        self.port = port
        self.baseline_path = baseline_path
        self.baseline = FabricBaselineStore(
            alpha=alpha, spread_mult=spread_mult,
            min_samples=min_samples)
        if baseline_path:
            self.baseline.load(baseline_path)
        self._probe_fn = probe_fn
        self._subgroup_probe_fn = subgroup_probe_fn
        self._localize = localize
        self.history_path = history_path
        self.history: collections.deque = collections.deque(
            maxlen=history_cap)
        self._built: dict = {}        # (axis, coll) -> (fn, n)
        self._built_sub: dict = {}    # (axis, ranks) -> subgroup
        self._next_sweep = 0.0        # due on the first poll
        self._slow_rank: dict[str, int | None] = {}
        self._was_degraded: dict[str, bool] = {}
        self._axis_state: dict[str, dict] = {}
        # Step-synchronized cadence for training loops (sweep every N
        # steps on every rank; see set_active); 0 disables.
        self.train_every = 0
        self.sweeps = 0
        self.last_sweep_s = 0.0
        self._stop = threading.Event()

        self.registry = registry or CollectorRegistry()
        self.busbw_g = Gauge(
            "fabric_probe_busbw_bytes_per_second",
            "Last probe-sweep busBW per (collective, axis, fabric), "
            "nccl-tests convention",
            ["collective", "axis", "fabric"], registry=self.registry)
        self.baseline_g = Gauge(
            "fabric_probe_baseline_bytes_per_second",
            "Learned healthy-busBW baseline center (EWMA) per "
            "(collective, axis, fabric)",
            ["collective", "axis", "fabric"], registry=self.registry)
        self.score_g = Gauge(
            "fabric_health_score",
            "Per-axis health: min over collectives of busBW / "
            "baseline center, clipped to 1.0 (1 = healthy)",
            ["axis"], registry=self.registry)
        self.degraded_g = Gauge(
            "fabric_degraded",
            "1 while the last sweep found any collective over this "
            "axis below its baseline band, else 0",
            ["axis"], registry=self.registry)
        self.slow_rank_g = Gauge(
            "fabric_slow_rank",
            "Rank named by the last localization pass over this axis "
            "(bisected subgroup ppermute probes); only set after a "
            "degradation localized",
            ["axis"], registry=self.registry)
        self.sweeps_c = Counter(
            "fabric_probe_sweeps_total", "Probe sweeps completed",
            [], registry=self.registry)
        self.sweep_seconds_g = Gauge(
            "fabric_probe_sweep_seconds",
            "Wall time of the last probe sweep",
            [], registry=self.registry)

    # ---- groups / axes (lazy: no group until a probe needs one) ----

    def _groups_or_build(self) -> dict:
        if self._groups is None:
            from container_engine_accelerators_tpu_torch.parallel import (
                distributed,
            )
            # One rank per process: a pure-dp group over every rank, so
            # a localization pass names individual ranks (cards).
            t0 = time.perf_counter()
            group = distributed.default_group(self.backend, self.device)
            init_s = time.perf_counter() - t0
            self.group_start = {"init_process_group_s": init_s,
                                **distributed.start_cost(group)}
            log.info("fabric health group: %s", json.dumps(
                self.group_start, sort_keys=True))
            self._groups = {"dp": group}
        return self._groups

    def axes(self) -> tuple[str, ...]:
        if self._axes is None:
            if self._probe_fn is not None:
                self._axes = ("dp",)
            else:
                groups = self._groups_or_build()
                multi = tuple(a for a, g in groups.items() if g.size() > 1)
                self._axes = multi or ("dp",)
        return self._axes

    def _group(self, axis: str):
        return self._groups_or_build()[axis]

    def axis_size(self, axis: str) -> int:
        if self._probe_fn is not None and self._groups is None:
            return 1
        group = self._groups_or_build().get(axis)
        return int(group.size()) if group is not None else 1

    # ---- probing ----

    def _built_probe(self, axis: str, coll: str):
        key = (axis, coll)
        if key not in self._built:
            from container_engine_accelerators_tpu_torch.ops.collectives import (  # noqa: E501
                build_probe,
            )
            self._built[key] = build_probe(self._group(axis), axis, coll)
        return self._built[key]

    def _probe_busbw(self, axis: str, coll: str) -> float:
        """One probe round -> busBW bytes/s, injection applied."""
        if self._probe_fn is not None:
            return float(self._probe_fn(axis, coll)) / injected_factor(
                axis)
        from container_engine_accelerators_tpu_torch.ops.collectives import (
            probe_collective,
        )
        prebuilt = self._built_probe(axis, coll)
        delay = injection_delay(axis)
        r = probe_collective(self._group(axis), axis, coll,
                             self.size_bytes, warmup=self.warmup,
                             iters=self.iters, prebuilt=prebuilt,
                             pre_delay_s=delay)
        return (r.bus_bw_gbps * 1e9) / injected_factor(axis)

    def _built_subgroup(self, axis: str, ranks: tuple):
        """The subgroup of `axis` over `ranks` (axis ranks), built once.
        Every rank calls this for every subgroup in the same order (the
        bisection is identical everywhere), since new_group is a
        collective call over the default group."""
        import torch.distributed as dist

        from container_engine_accelerators_tpu_torch.parallel.distributed import (  # noqa: E501
            global_rank,
        )
        key = (axis, ranks)
        if key not in self._built_sub:
            group = self._group(axis)
            self._built_sub[key] = dist.new_group(
                [global_rank(group, r) for r in ranks])
        return self._built_sub[key]

    def _subgroup_time(self, axis: str, ranks: tuple) -> float:
        """Wall seconds for one ppermute round confined to `ranks`,
        ended by a barrier over the whole axis."""
        if self._subgroup_probe_fn is not None:
            t = float(self._subgroup_probe_fn(axis, ranks))
            return t * injected_factor(axis, ranks)
        import torch
        import torch.distributed as dist

        from container_engine_accelerators_tpu_torch.ops.collectives import (
            _fence,
            build_probe,
        )
        from container_engine_accelerators_tpu_torch.parallel.distributed import (  # noqa: E501
            group_device,
        )
        group = self._group(axis)
        sub = self._built_subgroup(axis, ranks)
        n = int(group.size())
        member = group.rank() in ranks
        ring = build_probe(sub, axis, "ppermute")[0] if member else None
        dev = group_device(group)
        elems = max(self.size_bytes // 4, n)
        elems -= elems % n
        x = torch.zeros(elems // n, dtype=torch.float32, device=dev)
        one = torch.ones(1, dtype=torch.float32, device=dev)

        def once():
            if ring is not None:
                ring(x)
            # Full-axis barrier: every rank's wall time includes the
            # slowest subgroup member, so bisection decisions agree.
            dist.all_reduce(one, group=group)

        once()  # warmup (NCCL builds a subgroup's communicator here)
        _fence(dev)
        delay = injection_delay(axis, ranks)
        t0 = time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        for _ in range(max(self.iters, 1)):
            once()
        _fence(dev)
        dt = (time.perf_counter() - t0) / max(self.iters, 1)
        return dt * injected_factor(axis, ranks)

    def _consensus_any(self, axis: str, flag: bool) -> bool:
        """All-rank OR of a local boolean through a matched all-reduce.

        Verdicts of several ranks can disagree near the band edge (each
        keeps its own baseline), and the verdict gates the localization
        probes, more matched collectives: a rank that localizes while
        another goes on to its next step would pair mismatched calls.
        Every rank therefore runs this one all-reduce per axis per sweep
        unconditionally, so the branch is the same everywhere."""
        if self._probe_fn is not None:
            return flag
        group = self._group(axis)
        if group.size() <= 1:
            return flag
        import torch
        import torch.distributed as dist

        from container_engine_accelerators_tpu_torch.parallel.distributed import (  # noqa: E501
            group_device,
        )
        val = torch.tensor([1.0 if flag else 0.0],
                           device=group_device(group))
        dist.all_reduce(val, group=group)
        return float(val.item()) > 0.0

    def localize(self, axis: str) -> int | None:
        """Name the slowest rank on `axis` by bisection: probe each
        half of the surviving member set with a confined ppermute,
        recurse into the slower half. log2(n) * 2 probes."""
        n = self.axis_size(axis)
        members = list(range(n))
        if n <= 1:
            return 0 if members else None
        while len(members) > 1:
            half = len(members) // 2
            a, b = tuple(members[:half]), tuple(members[half:])
            ta = self._subgroup_time(axis, a)
            tb = self._subgroup_time(axis, b)
            members = list(a) if ta >= tb else list(b)
        return members[0]

    # ---- passive corroboration ----

    def observe_passive(self, axis: str, busbw_bytes_per_second: float,
                        collective: str = "all_reduce",
                        fabric: str | None = None) -> dict:
        """Feed a passively measured busBW sample (real training
        traffic) into the same baseline store the active probes use."""
        if fabric is None:
            from container_engine_accelerators_tpu_torch.ops.collectives import (  # noqa: E501
                axis_fabric,
            )
            fabric = axis_fabric(axis)
        key = f"{collective}.{axis}.{fabric}"
        ent = self.baseline.observe(key, busbw_bytes_per_second,
                                    source="passive")
        self._record_row(axis, collective, fabric,
                         busbw_bytes_per_second, ent,
                         source="passive")
        return ent

    # ---- the sweep ----

    def _record_row(self, axis, coll, fabric, busbw, ent,
                    source="probe", score=None, slow_rank=None,
                    write=True):
        """Build one probe-history row. With write=False the JSONL
        append is deferred (sweep_once stamps score/slow_rank on the
        worst row AFTER the per-collective loop, and the persisted
        row must carry them — tools/fabric_report.py reads the file,
        not the in-memory deque)."""
        row = {"kind": PROBE_ROW_KIND, "t": round(time.time(), 3),
               "axis": axis, "collective": coll, "fabric": fabric,
               "source": source,
               "busbw_bytes_per_second": round(float(busbw), 3),
               "baseline_bytes_per_second": round(ent["center"], 3),
               "spread": round(ent["spread"], 3), "n": ent["n"],
               "ratio": round(ent["ratio"], 4),
               "degraded": bool(ent["degraded"])}
        if score is not None:
            row["score"] = round(score, 4)
        if slow_rank is not None:
            row["slow_rank"] = slow_rank
        self.history.append(row)
        if write:
            self._write_history(row)
        return row

    def _write_history(self, row: dict) -> None:
        if not self.history_path:
            return
        try:
            line = json.dumps(row, sort_keys=True)
            fd = os.open(self.history_path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, (line + "\n").encode())
            finally:
                os.close(fd)
        except OSError:
            log.exception("fabric history append failed")

    def sweep_once(self, now: float | None = None) -> list[dict]:
        """Probe every axis x collective once; update baselines,
        gauges, events; localize on a healthy->degraded transition.
        Returns the probe rows."""
        if self._sweep_lock is None:
            return self._sweep(now)
        self.axes()  # a group comes up outside the lock
        with self._sweep_lock:
            return self._sweep(now)

    def _sweep(self, now: float | None) -> list[dict]:
        from container_engine_accelerators_tpu_torch.ops.collectives import (
            axis_fabric,
        )
        t0 = time.perf_counter()
        rows = []
        for axis in self.axes():
            fabric = axis_fabric(axis)
            ratios = []
            worst = None  # (ratio, row)
            degraded = False
            axis_rows = []
            for coll in self.collectives:
                busbw = self._probe_busbw(axis, coll)
                ent = self.baseline.observe(f"{coll}.{axis}.{fabric}",
                                            busbw)
                self.busbw_g.labels(collective=coll, axis=axis,
                                    fabric=fabric).set(busbw)
                self.baseline_g.labels(collective=coll, axis=axis,
                                       fabric=fabric).set(
                    ent["center"])
                row = self._record_row(axis, coll, fabric, busbw, ent,
                                       write=False)
                axis_rows.append(row)
                rows.append(row)
                if ent["n"] > self.baseline.min_samples or \
                        ent["degraded"]:
                    ratios.append(ent["ratio"])
                    if worst is None or ent["ratio"] < worst[0]:
                        worst = (ent["ratio"], row)
                degraded = degraded or ent["degraded"]
            # Matched on every rank, every sweep: the verdict gates
            # collectives (localization), so it must be identical
            # across processes even when local baselines disagree.
            degraded = self._consensus_any(axis, degraded)
            score = min(1.0, min(ratios)) if ratios else 1.0
            self.score_g.labels(axis=axis).set(score)
            self.degraded_g.labels(axis=axis).set(
                1.0 if degraded else 0.0)
            if events.enabled():
                events.counter("fabric/health",
                               {axis: round(score, 4)}, "fabric")
            slow_rank = self._slow_rank.get(axis)
            if degraded:
                if not self._was_degraded.get(axis, False) and \
                        self._localize:
                    slow_rank = self.localize(axis)
                    self._slow_rank[axis] = slow_rank
                    if slow_rank is not None:
                        self.slow_rank_g.labels(axis=axis).set(
                            slow_rank)
                wrow = worst[1] if worst else {}
                if events.enabled():
                    events.instant(
                        "fabric/degraded", "fabric",
                        {"axis": axis, "fabric": fabric,
                         "score": round(score, 4),
                         "collective": wrow.get("collective"),
                         "busbw_bytes_per_second":
                             wrow.get("busbw_bytes_per_second"),
                         "baseline_bytes_per_second":
                             wrow.get("baseline_bytes_per_second"),
                         "slow_rank": slow_rank})
                if wrow:
                    wrow["score"] = round(score, 4)
                    wrow["slow_rank"] = slow_rank
            elif self._was_degraded.get(axis, False):
                # Recovery clears the verdict: a drained-and-replaced
                # rank must not haunt the snapshot.
                self._slow_rank.pop(axis, None)
                slow_rank = None
            self._was_degraded[axis] = degraded
            self._axis_state[axis] = {
                "score": round(score, 4), "degraded": degraded,
                "fabric": fabric, "slow_rank": slow_rank}
            # History flush AFTER score/slow_rank stamping so the
            # persisted rows carry the episode verdict.
            for row in axis_rows:
                self._write_history(row)
        self.last_sweep_s = time.perf_counter() - t0
        self.sweep_seconds_g.set(self.last_sweep_s)
        self.sweeps += 1
        self.sweeps_c.inc()
        return rows

    def poll_once(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        if now < self._next_sweep:
            return
        # Schedule BEFORE sweeping: a slow sweep must not burst when
        # polls catch up (same discipline as FabricMetricServer).
        self._next_sweep = now + self.interval
        self.sweep_once(now)

    def maybe_sweep_step(self, step: int) -> bool:
        """Step-synchronized cadence for training loops: sweep when
        `step` is a multiple of `train_every`. Every rank calls this
        at the same step, so the probe collectives stay matched
        (SPMD) — the multi-process-safe alternative to the wall-clock
        poll thread."""
        if self.train_every <= 0 or step % self.train_every != 0:
            return False
        self.sweep_once()
        return True

    def start_poll_only(self) -> None:
        """Start just the sweep thread — co-registered mode, where
        another exporter already serves this registry's gauges on its
        port (cli/serve.py co-registers on the request-metrics
        registry)."""
        t = threading.Thread(target=self._poll_loop, daemon=True,
                             name=f"{self.name}-poll")
        self._threads = [t]
        t.start()

    # ---- snapshots / persistence ----

    def snapshot(self) -> dict:
        """State block for /debugz?state=1 (the fleet scraper's
        contract): worst axis + score + slow rank, mixed-version safe
        (absent entirely on replicas predating the field)."""
        axes = dict(self._axis_state)
        worst_axis = None
        worst = None
        for axis, st in axes.items():
            if worst is None or st["score"] < worst:
                worst, worst_axis = st["score"], axis
        wst = axes.get(worst_axis, {})
        return {"score": worst if worst is not None else 1.0,
                "degraded": int(sum(1 for s in axes.values()
                                    if s["degraded"])),
                "worst_axis": worst_axis,
                "slow_rank": wst.get("slow_rank"),
                "sweeps": self.sweeps, "axes": axes}

    def save_baseline(self, path: str | None = None) -> None:
        path = path or self.baseline_path
        if path:
            self.baseline.save(path)

    def stop(self) -> None:
        try:
            self.save_baseline()
        except OSError:
            log.exception("fabric baseline save failed")
        super().stop()
