"""tpu-doctor: a streaming SLO engine and incident diagnosis over the
flight recorder, the port's copy of the JAX package's metrics/doctor.py
(the same detectors, thresholds, incident bundle and metric families, so
one dashboard, one `trace doctor` and one chaos assertion read either).

The request recorder, the train recorder, the flight recorder, the
supervisor, heartbeats and the health checker emit the raw signal; this
module interprets it. Detectors watch the signals and, when one fires,
the process names the fault in a machine-readable incident bundle.

One diagnosis engine, two feeds:

  **Live.** `Doctor` subscribes a bounded tap to the process-wide
  EventBus (`events.subscribe()`: the tap counts its own drops, and the
  ring's overwrite counter rides every evaluation, so the doctor flags
  its own blind spots instead of diagnosing from silently truncated
  evidence). A daemon poll thread drains the tap into a sliding event
  history, samples the attached recorders and health-checker state, and
  runs the detector registry. It reads the recorders through their own
  locks, which are never held around device work, so it never waits on
  the card. `serve --doctor` / `train --doctor` wire it up;
  `/debugz?doctor=1` serves the live verdicts.

  **Offline.** `replay(trace)` steps the SAME detector registry over a
  merged flight-recorder timeline (`trace doctor MERGED.json`,
  cli/trace.py) by advancing a synthetic clock through the trace, so a
  live run and its own dump give identical verdicts. Dumps of either
  package replay through either package's doctor.

Detectors (each yields Findings; the registry is extensible):

  engine_hang      no decode-tick progress while decode slots are
                   occupied (the serve-side sibling of HangWatchdog)
  recompile_storm  steady-state XLA recompiles above a rate threshold;
                   it reads only `xla/recompile` events, which the port
                   never emits (its kernels are built once), so it
                   stays quiet in the port's processes and fires on
                   replayed dumps of the JAX package
  oom_precursor    device-memory bytes_in_use trending toward
                   bytes_limit, with a least-squares time-to-exhaustion
                   estimate
  queue_collapse   queue depth growing with ZERO admissions in the
                   window: requests arrive, nothing drains
  straggler        heartbeat skew across hb-<id> files / HangWatchdog
                   train/stalled instants naming the stuck rank
  health_storm     healthcheck ErrorEvents (health/<class> instants)
                   arriving in a burst
  slo_burn         multi-window error-budget burn on TTFT/TPOT/goodput
                   (fast and slow window alerting); the burn rates are
                   always exported as tpu_slo_burn_rate{slo,window}
  queue_storm, page_stall, kv_cold_waste, kv_thrash
                   span- and census-derived serving verdicts
  fabric_degraded, fabric_flap
                   fabric/* verdicts over the fabric health monitor's
                   health samples (metrics/fabric_health.py: serve or
                   train --fabric-health)
  replica_down, fleet_imbalance, fleet_slo_burn
                   fleet verdicts over fleetmon's fleet/* stream
                   (metrics/fleet.py)

Each firing emits exactly ONE deduplicated incident per (class,
subject) episode: an atomic (tmp + os.replace) JSON incident bundle
with the verdict class, confidence, evidence events out of the ring,
and metric snapshots; a `doctor/<class>` EventBus instant; and a
`tpu_doctor_incidents_total{class}` count on the host exporter. A
condition that persists keeps its incident active; one that stays quiet
for `clear_after_s` re-arms (a later recurrence is a new episode).

`FaultListener` is the chaos-injection half: it tails a JSONL
fault-command file (written by `cli/inject_fault.py --kind ...`) and
trips REAL failure modes in the live process (an engine-worker hang or
death, a data-loader stall, a health-checker storm) or fabricated
telemetry (an HBM climb, a queue collapse), so the detectors are tested
on the path production would take.

Nothing here imports torch: `trace doctor` and fleetmon run on hosts
without it.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import os
import threading
import time

from container_engine_accelerators_tpu_torch.metrics import events

log = logging.getLogger(__name__)

DOCTOR_DIR_ENV = "TPU_DOCTOR_DIR"

# Event names the engine-hang detector accepts as proof of forward
# progress: decode steps land counters, admissions/first tokens land
# async instants (metrics/request_metrics.py emits all of them).
_PROGRESS_COUNTERS = ("serve/decode_step_ms",)
_PROGRESS_INSTANTS = ("admit", "first_token", "preempt")


# ---------- configuration ----------

@dataclasses.dataclass
class SloSpec:
    """One service-level objective. For latency kinds ("ttft", "tpot")
    `threshold_s` bounds a single observation and `objective` is the
    fraction that must meet it (0.99 -> 1% error budget). For
    "goodput", `objective` is the minimum acceptable productive
    fraction of wall-clock. Burn rate 1.0 = consuming budget exactly
    at the allowed rate; an incident needs the fast AND slow windows
    burning (transients don't page, sustained burns do)."""

    name: str
    kind: str                      # ttft | tpot | goodput
    threshold_s: float | None = None
    objective: float = 0.99
    min_samples: int = 20
    fast_burn: float = 14.4        # SRE 1h/5m page-tier defaults,
    slow_burn: float = 6.0         # scaled to our window pair


def default_slos() -> list[SloSpec]:
    return [
        SloSpec("ttft_p99", "ttft", threshold_s=2.0, objective=0.99),
        SloSpec("tpot_p99", "tpot", threshold_s=0.25, objective=0.99),
        SloSpec("goodput", "goodput", objective=0.5),
    ]


@dataclasses.dataclass
class DoctorConfig:
    """Detector thresholds. Production defaults; tests shrink the
    windows to drive synthetic timelines."""

    poll_interval_s: float = 5.0
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    # engine_hang: seconds with occupied slots and no progress events.
    hang_after_s: float = 30.0
    # recompile_storm: steady-state recompiles within the fast window.
    recompile_storm_n: int = 3
    # oom_precursor: utilization watermark OR projected exhaustion.
    hbm_watermark: float = 0.92
    hbm_tte_s: float = 600.0
    hbm_min_samples: int = 4
    # queue_collapse: depth at/above this and growing, zero admits.
    queue_min_depth: int = 4
    # straggler: heartbeat age spread across processes.
    straggler_skew_s: float = 60.0
    health_storm_n: int = 3
    # queue_storm: this many req/queue spans longer than queue_storm_s
    # completing in the fast window (span-derived).
    queue_storm_s: float = 0.75
    queue_storm_n: int = 4
    # page_stall: req/page_stall spans (admission blocked on free
    # pages) longer than page_stall_s in the fast window.
    page_stall_s: float = 0.25
    page_stall_n: int = 2
    # kv_cold_waste: every serve/kv_thermal sample in the fast window
    # (at least kv_cold_min_samples of them) has a cold-bucket share
    # at/above kv_cold_share WHILE admission is page-limited
    # (req/page_stall spans in the window) — HBM held by dead pages
    # that live requests are stalling for.
    kv_cold_share: float = 0.5
    kv_cold_min_samples: int = 3
    # kv_thrash: this many kv/thrash instants (prefix pages evicted
    # then re-referenced within the index's horizon) in the fast
    # window — the cache is cycling pages it still needs.
    kv_thrash_n: int = 3
    # fleet_imbalance (metrics/fleet.py): sustained cross-replica skew
    # bands — queue-depth gap, KV-headroom fraction gap, and the
    # per-replica sample floor before either comparison is trusted.
    fleet_imbalance_queue: float = 6.0
    fleet_imbalance_headroom_frac: float = 0.5
    fleet_imbalance_min_samples: int = 4
    # fabric_degraded (metrics/fabric_health.py): this many
    # consecutive trailing fabric/health samples for one axis below
    # the score threshold — sustained busBW under the learned
    # baseline band, not one noisy probe.
    fabric_unhealthy_score: float = 0.75
    fabric_degraded_n: int = 3
    # fabric_flap: health-score threshold crossings for one axis in
    # the slow window — a link oscillating in and out of the band is
    # its own failure mode (no single episode sustains long enough
    # for fabric_degraded, but the fabric is not trustworthy).
    fabric_flap_n: int = 4
    # Incident episode hygiene: a quiet condition re-arms after this.
    clear_after_s: float = 30.0
    slos: list = dataclasses.field(default_factory=default_slos)
    # Event history horizon (doctor-side, independent of ring size).
    history_cap: int = 32768

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d["slos"] = [s["name"] for s in d["slos"]]
        return d


@dataclasses.dataclass
class Finding:
    """One detector verdict for one evaluation pass; the Doctor dedups
    these into incident episodes."""

    cls: str
    subject: str
    summary: str
    confidence: float
    evidence: dict


# ---------- signal snapshot (shared by live + offline paths) ----------

class Signals:
    """Uniform view the detectors read: a time-ordered event history
    (dicts with `name`/`cat`/`ph`/`ts`-seconds/`args`/`id`), the
    evaluation clock, and — live only — handles onto the recorders,
    health checker and heartbeat dir. Offline replay constructs the
    same object from a merged trace, which is what keeps the verdicts
    identical across both feeds."""

    def __init__(self, now: float, evs: list[dict], config: DoctorConfig,
                 request_recorder=None, train_recorder=None,
                 health_source=None, heartbeat_dir=None,
                 ring_dropped_delta: int = 0, live: bool = True):
        self.now = now
        self.events = evs
        self.config = config
        self.request_recorder = request_recorder
        self.train_recorder = train_recorder
        self.health_source = health_source
        self.heartbeat_dir = heartbeat_dir
        self.ring_dropped_delta = ring_dropped_delta
        self.live = live

    # -- windows --

    @property
    def fast_since(self) -> float:
        return self.now - self.config.fast_window_s

    @property
    def slow_since(self) -> float:
        return self.now - self.config.slow_window_s

    # -- queries --

    def named(self, name: str, ph: str | None = None,
              since: float | None = None) -> list[dict]:
        return [e for e in self.events
                if e["name"] == name
                and (ph is None or e["ph"] == ph)
                and (since is None or e["ts"] >= since)]

    def prefixed(self, prefix: str, ph: str | None = None,
                 since: float | None = None) -> list[dict]:
        return [e for e in self.events
                if e["name"].startswith(prefix)
                and (ph is None or e["ph"] == ph)
                and (since is None or e["ts"] >= since)]

    def series(self, name: str, since: float | None = None
               ) -> list[tuple[float, dict]]:
        """Counter samples for one track: [(ts, values)] oldest first."""
        return [(e["ts"], e["args"]) for e in self.named(name, "C", since)]

    def counter_groups(self, prefix: str, since: float | None = None
                       ) -> dict[str, list[tuple[float, dict]]]:
        """Counter tracks sharing a name prefix, keyed by the suffix
        (e.g. "hbm/" -> one series per device)."""
        out: dict[str, list] = {}
        for e in self.prefixed(prefix, "C", since):
            out.setdefault(e["name"][len(prefix):], []).append(
                (e["ts"], e["args"]))
        return out

    def async_spans(self, name: str, since: float | None = None,
                    include_open: bool = False) -> list[dict]:
        """Async b/e pairs for one span name, matched per event id:
        [{"id", "t0", "t1", "dur", "open"}], t1-ordered. `since` keeps
        spans that END (or, when open, still run) inside the window;
        `include_open` also returns unmatched begins with t1 = now —
        how a stall that has not resolved yet becomes visible."""
        begins: dict[str, list[float]] = {}
        out: list[dict] = []
        for e in self.events:
            if e["name"] != name or e.get("id") is None:
                continue
            rid = str(e["id"])
            if e["ph"] == "b":
                begins.setdefault(rid, []).append(e["ts"])
            elif e["ph"] == "e" and begins.get(rid):
                t0 = begins[rid].pop()
                if since is None or e["ts"] >= since:
                    out.append({"id": rid, "t0": t0, "t1": e["ts"],
                                "dur": e["ts"] - t0, "open": False})
        if include_open:
            for rid, stack in begins.items():
                for t0 in stack:
                    out.append({"id": rid, "t0": t0, "t1": self.now,
                                "dur": self.now - t0, "open": True})
        out.sort(key=lambda s: s["t1"])
        return out

    def ttft_samples(self, since: float) -> list[float]:
        """Per-request TTFT seconds derived from the request async
        span: `request` begin (ph b) to the `first_token` instant
        (ph n), keyed by request id — the event-derived twin of the
        recorder's ttft histogram, available offline."""
        begins: dict[str, float] = {}
        out: list[float] = []
        for e in self.events:
            if e["ph"] == "b" and e["name"] == "request":
                if e.get("id") is not None:
                    begins[str(e["id"])] = e["ts"]
            elif (e["ph"] == "n" and e["name"] == "first_token"
                  and e["ts"] >= since):
                t0 = begins.get(str(e.get("id")))
                if t0 is not None:
                    out.append(e["ts"] - t0)
        return out


def _evidence_event(e: dict) -> dict:
    """Evidence pointer into the event ring: enough of the event to
    find it again in a dump (name + ph + µs timestamp) plus its args."""
    d = {"name": e["name"], "ph": e["ph"], "ts_us": round(e["ts"] * 1e6, 3)}
    if e.get("args"):
        d["args"] = e["args"]
    if e.get("id") is not None:
        d["id"] = str(e["id"])
    return d


# ---------- detectors ----------

class Detector:
    """One diagnosis rule: inspect a Signals snapshot, return zero or
    more Findings. Detectors must be pure over the snapshot (no side
    effects) — the Doctor owns dedup, emission and metrics."""

    cls = "?"

    def check(self, sig: Signals) -> list[Finding]:
        raise NotImplementedError


class EngineHangDetector(Detector):
    """Decode slots occupied with no forward progress: the last
    serve/slots counter shows active > 0 and no decode step /
    admission / first-token event has landed for hang_after_s. During
    a true hang the wedged worker emits nothing, so absence of NEW
    slot counters is itself corroborating silence."""

    cls = "engine_hang"

    def check(self, sig):
        slots = sig.series("serve/slots")
        if not slots:
            return []
        ts_last, vals = slots[-1]
        if vals.get("active", 0) <= 0:
            return []
        # Occupied since: walk back over the trailing active>0 run.
        occupied_since = ts_last
        for ts, v in reversed(slots):
            if v.get("active", 0) <= 0:
                break
            occupied_since = ts
        progress = [e["ts"] for e in sig.events
                    if (e["ph"] == "C" and e["name"] in _PROGRESS_COUNTERS)
                    or (e["ph"] == "n"
                        and e["name"] in _PROGRESS_INSTANTS)]
        last_progress = max((t for t in progress if t >= occupied_since),
                            default=None)
        ref = last_progress if last_progress is not None else occupied_since
        stalled_s = sig.now - ref
        if stalled_s < sig.config.hang_after_s:
            return []
        ev = {"stalled_s": round(stalled_s, 3),
              "occupied_since": round(occupied_since, 3),
              "slots": vals,
              "events": [_evidence_event(
                  {"name": "serve/slots", "ph": "C", "ts": ts_last,
                   "args": vals})]}
        if last_progress is not None:
            ev["last_progress_s_ago"] = round(sig.now - last_progress, 3)
        return [Finding(
            self.cls, "serve",
            f"decode slots occupied ({vals.get('active')}/"
            f"{vals.get('total')}) with no decode progress for "
            f"{stalled_s:.1f}s", 0.9, ev)]


class RecompileStormDetector(Detector):
    """Steady-state XLA recompiles above rate: every one stalls the
    engine for a full compile pipeline, and a storm means shapes are
    escaping the bucketing. Evidence carries the CompileTracker's
    exact dimension diff. Reads only `xla/recompile` instants, which
    the JAX package's CompileTracker emits and the port never does (it
    compiles nothing at run time): quiet in the port's processes, it
    fires on replayed JAX dumps."""

    cls = "recompile_storm"

    def check(self, sig):
        recs = sig.named("xla/recompile", "i", sig.fast_since)
        if len(recs) < sig.config.recompile_storm_n:
            return []
        fns = collections.Counter(
            e["args"].get("fn", "?") for e in recs)
        top_fn, top_n = fns.most_common(1)[0]
        ev = {"count": len(recs),
              "window_s": sig.config.fast_window_s,
              "fns": dict(fns),
              "last_diff": recs[-1]["args"].get("diff"),
              "events": [_evidence_event(e) for e in recs[-5:]]}
        return [Finding(
            self.cls, top_fn,
            f"{len(recs)} steady-state XLA recompiles in "
            f"{sig.config.fast_window_s:.0f}s ({top_n} on {top_fn}); "
            f"last diff: {ev['last_diff']}", 0.95, ev)]


class OomPrecursorDetector(Detector):
    """Device-memory bytes_in_use trending toward bytes_limit on any
    device (the hbm/<device> tracks of introspection.HbmPoller, which
    reads torch.cuda.mem_get_info: the card's use by every process on
    it): fires at the utilization watermark, or earlier when a
    least-squares fit over the window projects exhaustion within
    hbm_tte_s, the 'you will OOM in ~N seconds' verdict the post-hoc
    OOM forensics bundle can only write after the fact."""

    cls = "oom_precursor"

    def check(self, sig):
        out = []
        for dev, series in sig.counter_groups("hbm/",
                                              sig.slow_since).items():
            pts = [(ts, v["bytes_in_use"], v.get("bytes_limit", 0))
                   for ts, v in series if "bytes_in_use" in v]
            if len(pts) < sig.config.hbm_min_samples:
                continue
            ts_l, used_l, limit_l = pts[-1]
            if not limit_l:
                continue
            util = used_l / limit_l
            slope = _lsq_slope([(t, u) for t, u, _ in pts])
            tte = ((limit_l - used_l) / slope
                   if slope and slope > 0 else None)
            if not (util >= sig.config.hbm_watermark
                    or (tte is not None and tte <= sig.config.hbm_tte_s)):
                continue
            ev = {"device": dev, "utilization": round(util, 4),
                  "bytes_in_use": used_l, "bytes_limit": limit_l,
                  "slope_bytes_per_s": round(slope, 1) if slope else 0.0,
                  "tte_s": round(tte, 1) if tte is not None else None,
                  "samples": len(pts),
                  "events": [_evidence_event(
                      {"name": f"hbm/{dev}", "ph": "C", "ts": t,
                       "args": {"bytes_in_use": u, "bytes_limit": lim}})
                      for t, u, lim in pts[-3:]]}
            if sig.live:
                ev["hbm_plan"] = _expected_hbm()
            tte_txt = (f"exhaustion in ~{tte:.0f}s"
                       if tte is not None else "at watermark")
            out.append(Finding(
                self.cls, dev,
                f"HBM {dev} at {util * 100:.1f}% and climbing "
                f"({ev['slope_bytes_per_s']:.0f} B/s): {tte_txt}",
                0.85, ev))
        return out


class QueueCollapseDetector(Detector):
    """Queue depth at/above threshold and GROWING across the fast
    window with zero admissions: traffic arrives, nothing drains —
    the admission path (not the decode path) is dead.

    Two-queue layout (serve --prefill-workers): the engine also emits
    a per-pool serve/pool_depth counter, and each pool has its own
    progress heartbeat — serve/prefill_chunk_tokens for the prefill
    pool, serve/decode_step_ms for the decode pool. A pool whose depth
    grows past threshold while ITS heartbeat is silent has collapsed
    even though the other pool (and total admission) looks healthy, so
    each fires its own finding naming the pool."""

    cls = "queue_collapse"

    # (pool key in serve/pool_depth args, progress counter, label)
    _POOLS = (("prefill", "serve/prefill_chunk_tokens",
               "prefill chunks"),
              ("decode", "serve/decode_step_ms", "decode steps"))

    def check(self, sig):
        return self._check_total(sig) + self._check_pools(sig)

    def _check_total(self, sig):
        series = sig.series("serve/queue_depth", sig.fast_since)
        if len(series) < 2:
            return []
        depth_first = series[0][1].get("queued", 0)
        ts_last, last = series[-1]
        depth_last = last.get("queued", 0)
        if depth_last < sig.config.queue_min_depth:
            return []
        if depth_last <= depth_first:
            return []
        if sig.named("admit", "n", sig.fast_since):
            return []
        ev = {"depth": depth_last, "depth_window_start": depth_first,
              "window_s": sig.config.fast_window_s,
              "events": [_evidence_event(
                  {"name": "serve/queue_depth", "ph": "C", "ts": ts,
                   "args": v}) for ts, v in series[-3:]]}
        return [Finding(
            self.cls, "serve",
            f"queue depth grew {depth_first} -> {depth_last} with "
            f"zero admits in {sig.config.fast_window_s:.0f}s",
            0.9, ev)]

    def _check_pools(self, sig):
        series = sig.series("serve/pool_depth", sig.fast_since)
        if len(series) < 2:
            return []
        out = []
        for pool, progress, label in self._POOLS:
            depth_first = series[0][1].get(pool, 0)
            depth_last = series[-1][1].get(pool, 0)
            if depth_last < sig.config.queue_min_depth:
                continue
            if depth_last <= depth_first:
                continue
            if sig.named(progress, "C", sig.fast_since):
                continue
            ev = {"pool": pool, "depth": depth_last,
                  "depth_window_start": depth_first,
                  "window_s": sig.config.fast_window_s,
                  "events": [_evidence_event(
                      {"name": "serve/pool_depth", "ph": "C", "ts": ts,
                       "args": v}) for ts, v in series[-3:]]}
            out.append(Finding(
                self.cls, f"serve/{pool}-pool",
                f"{pool} pool depth grew {depth_first} -> {depth_last} "
                f"with zero {label} in {sig.config.fast_window_s:.0f}s",
                0.9, ev))
        return out


class StragglerDetector(Detector):
    """Names the slow rank: a HangWatchdog train/stalled instant on
    the timeline (works offline too), or — live, with a heartbeat dir
    attached — hb-<id> mtime skew beyond straggler_skew_s while at
    least one process stays fresh (the skew form catches a straggler
    BEFORE the absolute-age watchdog threshold trips).

    A rank with an IN-FLIGHT asynchronous checkpoint save is not a
    straggler: its last ckpt/async_save instant has phase=start with
    no matching end, meaning a background commit is running and the
    step loop may legitimately pause at the next save boundary. The
    exemption never applies to elastic-sourced stalls (train/stalled
    with source=elastic): those carry peer-DEATH evidence — a provably
    dead pid — not slowness, and suppressing them would hide real
    losses behind a save that will never finish."""

    cls = "straggler"

    def _async_save_in_flight(self, sig) -> set:
        """Processes whose newest ckpt/async_save instant is an
        unmatched phase=start (CheckpointManager emits start on the
        step path and end from the writer thread)."""
        last: dict = {}
        for e in sig.named("ckpt/async_save", "i", 0.0):
            proc = e["args"].get("process")
            if proc is not None:
                last[proc] = e["args"].get("phase")
        return {p for p, phase in last.items() if phase == "start"}

    def check(self, sig):
        in_flight = self._async_save_in_flight(sig)
        stalls = sig.named("train/stalled", "i", sig.fast_since)
        stalls = [e for e in stalls
                  if e["args"].get("source") == "elastic"
                  or e["args"].get("process") not in in_flight]
        if stalls:
            last = stalls[-1]
            proc = last["args"].get("process", "?")
            ev = {"source": "hang_watchdog",
                  "process": proc,
                  "age_s": last["args"].get("age_s"),
                  "events": [_evidence_event(e) for e in stalls[-3:]]}
            return [Finding(
                self.cls, f"process-{proc}",
                f"hang watchdog reports process {proc} heartbeat "
                f"{last['args'].get('age_s', '?')}s old", 0.9, ev)]
        if not (sig.live and sig.heartbeat_dir):
            return []
        ages = _heartbeat_ages(sig.heartbeat_dir)
        if len(ages) < 2:
            return []
        worst = max(ages, key=lambda p: ages[p])
        skew = ages[worst] - min(ages.values())
        if skew < sig.config.straggler_skew_s:
            return []
        if worst in in_flight:
            return []
        ev = {"source": "heartbeat_skew",
              "ages_s": {str(k): round(v, 1) for k, v in ages.items()},
              "skew_s": round(skew, 1)}
        return [Finding(
            self.cls, f"process-{worst}",
            f"process {worst} heartbeat lags the freshest peer by "
            f"{skew:.0f}s", 0.75, ev)]


class HealthStormDetector(Detector):
    """A burst of healthcheck ErrorEvents (health/<class> instants from
    healthcheck/health_checker.py) in the fast window: one flaky line
    is noise, a storm is a node going bad under the workload."""

    cls = "health_storm"

    def check(self, sig):
        errs = sig.prefixed("health/", "i", sig.fast_since)
        if len(errs) < sig.config.health_storm_n:
            return []
        classes = collections.Counter(
            e["name"].split("/", 1)[1] for e in errs)
        top_cls, top_n = classes.most_common(1)[0]
        critical = any(e["args"].get("critical") for e in errs)
        ev = {"count": len(errs), "classes": dict(classes),
              "critical": critical,
              "window_s": sig.config.fast_window_s,
              "events": [_evidence_event(e) for e in errs[-5:]]}
        if sig.live and sig.health_source is not None:
            try:
                ev["checker"] = sig.health_source.error_summary()
            except Exception:
                log.exception("health source summary failed")
        return [Finding(
            self.cls, top_cls,
            f"{len(errs)} TPU health errors in "
            f"{sig.config.fast_window_s:.0f}s (top: {top_cls} x{top_n}"
            f"{', critical' if critical else ''})",
            0.9 if critical else 0.7, ev)]


class SloBurnDetector(Detector):
    """Multi-window error-budget burn: an SLO pages only when BOTH the
    fast and slow windows burn above their thresholds (fast alone =
    transient, slow alone = old news). The burn rates themselves are
    exported continuously by the Doctor whether or not anything fires."""

    cls = "slo_burn"

    def check(self, sig):
        out = []
        for spec in sig.config.slos:
            fast, n_fast = slo_burn(sig, spec, sig.config.fast_window_s)
            slow, _ = slo_burn(sig, spec, sig.config.slow_window_s)
            if n_fast < spec.min_samples and spec.kind != "goodput":
                continue
            if fast < spec.fast_burn or slow < spec.slow_burn:
                continue
            ev = {"slo": spec.name, "kind": spec.kind,
                  "objective": spec.objective,
                  "threshold_s": spec.threshold_s,
                  "burn_fast": round(fast, 2), "burn_slow": round(slow, 2),
                  "samples_fast": n_fast,
                  "windows_s": [sig.config.fast_window_s,
                                sig.config.slow_window_s]}
            out.append(Finding(
                self.cls, spec.name,
                f"SLO {spec.name} burning error budget at "
                f"{fast:.1f}x (fast) / {slow:.1f}x (slow) the "
                f"sustainable rate", 0.8, ev))
        return out


class QueueStormDetector(Detector):
    """Span-derived admission-wait inflation: multiple
    requests' req/queue spans (enqueue -> admit, re-opened on preempt)
    run long inside the fast window. Distinct from queue_collapse —
    requests ARE admitted, just slowly: the backlog is churning, not
    dead. The verdict names the triggering request ids so the operator
    can jump straight to their tracks in the merged Perfetto trace."""

    cls = "queue_storm"

    def check(self, sig):
        spans = sig.async_spans("req/queue", sig.fast_since,
                                include_open=True)
        slow = [s for s in spans if s["dur"] >= sig.config.queue_storm_s]
        if len(slow) < sig.config.queue_storm_n:
            return []
        rids = sorted({s["id"] for s in slow})
        worst = max(slow, key=lambda s: s["dur"])
        ev = {"count": len(slow), "rids": rids,
              "threshold_s": sig.config.queue_storm_s,
              "worst_s": round(worst["dur"], 3),
              "window_s": sig.config.fast_window_s,
              "events": [_evidence_event(
                  {"name": "req/queue", "ph": "e", "ts": s["t1"],
                   "id": s["id"],
                   "args": {"dur_s": round(s["dur"], 3),
                            "open": s["open"]}})
                  for s in slow[-5:]]}
        return [Finding(
            self.cls, "serve",
            f"{len(slow)} requests waited >= "
            f"{sig.config.queue_storm_s:.2f}s for admission in "
            f"{sig.config.fast_window_s:.0f}s (worst "
            f"{worst['dur']:.2f}s, rid {worst['id']})", 0.85, ev)]


class PageStallDetector(Detector):
    """Span-derived KV page starvation: req/page_stall
    spans — admission blocked on free pages, opened at the first
    failed alloc and closed at the successful retry — exceeding
    page_stall_s. Open spans count at their current age, so a stall
    that never resolves still fires. The page pool, not compute, is
    the bottleneck: raise --pool-pages or shrink --prefix-cache-cap."""

    cls = "page_stall"

    def check(self, sig):
        spans = sig.async_spans("req/page_stall", sig.fast_since,
                                include_open=True)
        long = [s for s in spans if s["dur"] >= sig.config.page_stall_s]
        if len(long) < sig.config.page_stall_n:
            return []
        rids = sorted({s["id"] for s in long})
        worst = max(long, key=lambda s: s["dur"])
        ev = {"count": len(long), "rids": rids,
              "threshold_s": sig.config.page_stall_s,
              "worst_s": round(worst["dur"], 3),
              "still_open": sum(1 for s in long if s["open"]),
              "window_s": sig.config.fast_window_s,
              "events": [_evidence_event(
                  {"name": "req/page_stall", "ph": "e", "ts": s["t1"],
                   "id": s["id"],
                   "args": {"dur_s": round(s["dur"], 3),
                            "open": s["open"]}})
                  for s in long[-5:]]}
        return [Finding(
            self.cls, "serve",
            f"{len(long)} admissions blocked >= "
            f"{sig.config.page_stall_s:.2f}s on free KV pages in "
            f"{sig.config.fast_window_s:.0f}s (worst "
            f"{worst['dur']:.2f}s, rid {worst['id']})", 0.85, ev)]


class KvColdWasteDetector(Detector):
    """HBM wasted on dead KV pages: EVERY serve/kv_thermal
    census sample in the fast window shows a cold-bucket share at or
    above kv_cold_share, while admission is page-limited in the same
    window (req/page_stall spans, open ones included). Evidence names
    the tenant holding the most cold pages from the latest
    serve/kv_tenant_cold sample — the occupant the tier (or a smaller
    --prefix-cache-cap) would evict first."""

    cls = "kv_cold_waste"

    def check(self, sig):
        series = sig.series("serve/kv_thermal", sig.fast_since)
        if len(series) < sig.config.kv_cold_min_samples:
            return []
        shares = []
        for _, v in series:
            total = (v.get("hot", 0) + v.get("warm", 0)
                     + v.get("cold", 0))
            if total <= 0:
                return []  # an empty pool has no waste
            shares.append(v.get("cold", 0) / total)
        if min(shares) < sig.config.kv_cold_share:
            return []  # sustained means every sample in the window
        stalls = sig.async_spans("req/page_stall", sig.fast_since,
                                 include_open=True)
        if not stalls:
            return []  # cold pages nobody is waiting on are free HBM
        ts_last, last = series[-1]
        tenant_cold: dict = {}
        coldest_tenant = None
        tcold = sig.series("serve/kv_tenant_cold", sig.fast_since)
        if tcold:
            tenant_cold = dict(tcold[-1][1])
            if tenant_cold:
                coldest_tenant = max(tenant_cold,
                                     key=lambda t: tenant_cold[t])
        ev = {"cold_share_min": round(min(shares), 3),
              "cold_share_last": round(shares[-1], 3),
              "threshold": sig.config.kv_cold_share,
              "samples": len(shares),
              "window_s": sig.config.fast_window_s,
              "cold_pages": last.get("cold"),
              "working_set_pages": last.get("wss"),
              "page_stalls": len(stalls),
              "tenant_cold_pages": tenant_cold,
              "coldest_tenant": coldest_tenant,
              "events": [_evidence_event(
                  {"name": "serve/kv_thermal", "ph": "C", "ts": ts,
                   "args": v}) for ts, v in series[-5:]]}
        who = (f"; coldest tenant {coldest_tenant} holds "
               f"{tenant_cold.get(coldest_tenant)} of them"
               if coldest_tenant is not None else "")
        return [Finding(
            self.cls, "serve",
            f"{last.get('cold', 0)} KV pages ({shares[-1] * 100:.0f}% "
            f"of the pool) stayed cold for the whole "
            f"{sig.config.fast_window_s:.0f}s window while "
            f"{len(stalls)} admissions stalled on free pages{who}",
            0.8, ev)]


class KvThrashDetector(Detector):
    """Prefix-cache thrash: kv/thrash instants — a prefix
    page evicted under pressure and re-referenced within the index's
    horizon — reaching kv_thrash_n in the fast window. Each of those
    misses recomputes a page that WAS resident: the pool/cache is
    sized below the prefix working set (raise --prefix-cache-cap or
    --pool-pages, or offload the cold tail to the host tier)."""

    cls = "kv_thrash"

    def check(self, sig):
        hits = sig.named("kv/thrash", "i", sig.fast_since)
        if len(hits) < sig.config.kv_thrash_n:
            return []
        ages = sorted(e.get("args", {}).get("age_s", 0.0)
                      for e in hits)
        ev = {"count": len(hits),
              "threshold_n": sig.config.kv_thrash_n,
              "window_s": sig.config.fast_window_s,
              "reref_age_p50_s": ages[len(ages) // 2],
              "reref_age_max_s": ages[-1],
              "events": [_evidence_event(e) for e in hits[-5:]]}
        return [Finding(
            self.cls, "serve",
            f"{len(hits)} prefix pages evicted then re-referenced "
            f"within {ages[-1]:.1f}s in the last "
            f"{sig.config.fast_window_s:.0f}s — the prefix cache is "
            f"cycling pages it still needs", 0.85, ev)]


def _fabric_score_series(sig, since: float) -> dict[str, dict]:
    """fabric/health counter samples ({axis: score} per sample)
    regrouped as {axis: {pid: [(ts, score), ...]}}.

    Grouped per emitting process, not just per axis: a merged
    multi-process timeline interleaves every rank's score stream for
    the same axis, and the ranks legitimately disagree during an
    episode (the throttled rank reads lower than its dragged peers).
    Judging the interleaved stream would see phantom oscillation and
    break trailing-window checks."""
    per_axis: dict[str, dict] = {}
    for e in sig.named("fabric/health", "C", since):
        pid = e.get("pid", 0)
        for axis, score in e.get("args", {}).items():
            try:
                per_axis.setdefault(axis, {}).setdefault(
                    pid, []).append((e["ts"], float(score)))
            except (TypeError, ValueError):
                continue
    return per_axis


class FabricDegradedDetector(Detector):
    """Sustained fabric degradation: the trailing
    fabric_degraded_n fabric/health samples for one axis all sit
    below fabric_unhealthy_score — busBW under the learned baseline
    band sweep after sweep, not one noisy probe. Evidence carries the
    probe rows behind the verdict and the localization pass's slow
    rank (the node-problem-detector role: the incident NAMES the
    rank to drain). Reads only the fabric/* events of
    metrics/fabric_health.py's monitor."""

    cls = "fabric_degraded"

    def check(self, sig):
        out = []
        for axis, by_pid in _fabric_score_series(
                sig, sig.fast_since).items():
            n = sig.config.fabric_degraded_n
            # One finding per axis: the worst qualifying rank's
            # stream speaks for the episode.
            tail = None
            for samples in by_pid.values():
                if len(samples) < n:
                    continue
                cand = samples[-n:]
                if max(s for _, s in cand) >= \
                        sig.config.fabric_unhealthy_score:
                    continue
                if tail is None or cand[-1][1] < tail[-1][1]:
                    tail = cand
            if tail is None:
                continue
            deg = [e for e in sig.named("fabric/degraded", "i",
                                        sig.fast_since)
                   if e.get("args", {}).get("axis") == axis]
            last = deg[-1].get("args", {}) if deg else {}
            slow_rank = last.get("slow_rank")
            # Probe rows: the per-(collective.axis.fabric) busBW
            # counter samples emitted by probe_collective, restricted
            # to this axis.
            probe_rows = []
            for ts, vals in sig.series("fabric/busbw_gbps",
                                       sig.fast_since)[-8:]:
                rows = {k: v for k, v in vals.items()
                        if f".{axis}." in f".{k}."}
                if rows:
                    probe_rows.append({"ts": round(ts, 3), **rows})
            loc = (f"axis {axis}: slow rank {slow_rank}"
                   if slow_rank is not None
                   else f"axis {axis}: not localized")
            ev = {"axis": axis, "fabric": last.get("fabric"),
                  "score_last": round(tail[-1][1], 4),
                  "score_threshold":
                      sig.config.fabric_unhealthy_score,
                  "samples_below": n,
                  "window_s": sig.config.fast_window_s,
                  "collective": last.get("collective"),
                  "busbw_bytes_per_second":
                      last.get("busbw_bytes_per_second"),
                  "baseline_bytes_per_second":
                      last.get("baseline_bytes_per_second"),
                  "slow_rank": slow_rank,
                  "localization": loc,
                  "probe_rows": probe_rows,
                  "events": [_evidence_event(e) for e in deg[-5:]]}
            who = (f"; localization names rank {slow_rank}"
                   if slow_rank is not None else "")
            out.append(Finding(
                self.cls, axis,
                f"fabric busBW over axis {axis} stayed below "
                f"{sig.config.fabric_unhealthy_score:.0%} of its "
                f"learned baseline for {n} consecutive probe sweeps"
                f"{who}", 0.85, ev))
        return out


class FabricFlapDetector(Detector):
    """Oscillating fabric health: the per-axis health
    score crossed the fabric_unhealthy_score threshold at least
    fabric_flap_n times inside the slow window. No single episode
    sustains long enough for fabric_degraded, but a link bouncing in
    and out of its baseline band is failing — retrain routing or
    drain it before it hard-fails mid-collective."""

    cls = "fabric_flap"

    def check(self, sig):
        out = []
        thr = sig.config.fabric_unhealthy_score
        for axis, by_pid in _fabric_score_series(
                sig, sig.slow_since).items():
            # Crossings are counted within one rank's stream — across
            # ranks the scores legitimately differ mid-episode, which
            # is degradation, not flapping.
            crossings, samples = 0, None
            for cand in by_pid.values():
                if len(cand) < sig.config.fabric_flap_n + 1:
                    continue
                c = 0
                prev_bad = cand[0][1] < thr
                for _, score in cand[1:]:
                    bad = score < thr
                    if bad != prev_bad:
                        c += 1
                        prev_bad = bad
                if c > crossings:
                    crossings, samples = c, cand
            if crossings < sig.config.fabric_flap_n:
                continue
            ev = {"axis": axis, "crossings": crossings,
                  "threshold_n": sig.config.fabric_flap_n,
                  "score_threshold": thr,
                  "window_s": sig.config.slow_window_s,
                  "score_last": round(samples[-1][1], 4),
                  "samples": len(samples)}
            out.append(Finding(
                self.cls, axis,
                f"fabric health over axis {axis} crossed the "
                f"{thr:.0%}-of-baseline line {crossings} times in "
                f"{sig.config.slow_window_s:.0f}s — flapping, not a "
                f"single degradation episode", 0.7, ev))
        return out


def default_detectors() -> list[Detector]:
    # Lazy import: fleet.py imports Detector/Finding from this module
    # at its top, so the fleet registry slice must load inside the
    # function body. The fleet detectors read only the fleet/* event
    # namespace and stay quiet in any process without a FleetScraper.
    from container_engine_accelerators_tpu_torch.metrics import fleet

    return [EngineHangDetector(), RecompileStormDetector(),
            OomPrecursorDetector(), QueueCollapseDetector(),
            StragglerDetector(), HealthStormDetector(),
            SloBurnDetector(), QueueStormDetector(),
            PageStallDetector(), KvColdWasteDetector(),
            KvThrashDetector(), FabricDegradedDetector(),
            FabricFlapDetector(), *fleet.fleet_detectors()]


# ---------- detector helpers ----------

def _lsq_slope(pts: list[tuple[float, float]]) -> float | None:
    """Least-squares slope of y over t; None for degenerate inputs."""
    n = len(pts)
    if n < 2:
        return None
    mt = sum(t for t, _ in pts) / n
    my = sum(y for _, y in pts) / n
    den = sum((t - mt) ** 2 for t, _ in pts)
    if den <= 0:
        return None
    return sum((t - mt) * (y - my) for t, y in pts) / den


def _heartbeat_ages(hb_dir: str) -> dict[int, float]:
    """Heartbeat-file ages (seconds) by process id, the HangWatchdog
    file contract (train_metrics.py hb-<id>)."""
    # Wall clock against wall clock: ages come from file mtimes.
    now = time.time()
    ages: dict[int, float] = {}
    try:
        names = os.listdir(hb_dir)
    except OSError:
        return ages
    for name in names:
        if not (name.startswith("hb-") and name[3:].isdigit()):
            continue
        try:
            mtime = os.stat(os.path.join(hb_dir, name)).st_mtime
        except OSError:
            continue  # racing a writer's replace
        ages[int(name[3:])] = max(0.0, now - mtime)
    return ages


def _expected_hbm():
    """The hbm_plan expectation recorded at launch (introspection), for
    oom_precursor evidence; None when no plan was set."""
    try:
        from container_engine_accelerators_tpu_torch.metrics import (
            introspection,
        )
        return introspection.expected_hbm()
    except Exception:
        return None


def slo_burn(sig: Signals, spec: SloSpec, window_s: float
             ) -> tuple[float, int]:
    """(burn_rate, n_samples) for one SLO over one window. Latency
    kinds prefer the recorder's timestamped samples (live) and fall
    back to event-derived values (offline replay); goodput reads the
    cumulative train/goodput_fraction counter either way, so live and
    offline agree."""
    since = sig.now - window_s
    budget = max(1e-6, 1.0 - spec.objective)
    if spec.kind == "goodput":
        frac = None
        rec = sig.train_recorder
        if rec is not None:
            try:
                frac = rec.goodput(now=sig.now)["goodput_fraction"]
            except Exception:
                log.exception("goodput sample failed")
        if frac is None:
            series = sig.series("train/goodput_fraction", since)
            if series:
                frac = series[-1][1].get("fraction")
        if frac is None:
            return 0.0, 0
        return max(0.0, 1.0 - frac) / budget, 1
    if spec.kind in ("ttft", "tpot"):
        rec = sig.request_recorder
        if rec is not None:
            n, bad = rec.window_counts(spec.kind, since,
                                       spec.threshold_s)
        elif spec.kind == "ttft":
            xs = sig.ttft_samples(since)
            n = len(xs)
            bad = sum(1 for x in xs if x > spec.threshold_s)
        else:
            return 0.0, 0  # tpot has no event-derived form (yet)
        if n == 0:
            return 0.0, 0
        return (bad / n) / budget, n
    log.warning("unknown SLO kind %r", spec.kind)
    return 0.0, 0


# ---------- the doctor ----------

def _raw_to_dict(ev: tuple) -> dict:
    """EventBus ring tuple -> the detector event-dict form."""
    ph, ts, _tid, name, cat, _dur, eid, args = ev
    return {"name": name, "cat": cat or "", "ph": ph, "ts": ts,
            "args": dict(args) if args else {}, "id": eid}


def trace_to_events(trace: dict) -> list[dict]:
    """Chrome-trace JSON (a raw EventBus dump or a `trace merge`
    output) -> time-ordered detector event dicts (ts in seconds,
    whatever epoch the trace used — detectors only need deltas)."""
    out = []
    for ev in trace.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            continue
        out.append({"name": ev.get("name", ""),
                    "cat": ev.get("cat", ""), "ph": ph,
                    "ts": float(ev.get("ts", 0.0)) / 1e6,
                    "args": ev.get("args") or {}, "id": ev.get("id")})
    out.sort(key=lambda e: e["ts"])
    return out


class Doctor:
    """The diagnosis engine. Live: `start()` subscribes the EventBus
    tap and polls on a daemon thread. Offline: `replay()` drives
    `evaluate()` with a synthetic clock. Both paths share ingest ->
    Signals -> detectors -> dedup -> incident emission."""

    def __init__(self, config: DoctorConfig | None = None,
                 registry=None, request_recorder=None,
                 train_recorder=None, health_source=None,
                 heartbeat_dir: str | None = None,
                 out_dir: str | None = "auto",
                 detectors: list[Detector] | None = None,
                 bus: events.EventBus | None = None,
                 live: bool = True):
        self.config = config or DoctorConfig()
        self.request_recorder = request_recorder
        self.train_recorder = train_recorder
        self.health_source = health_source
        self.heartbeat_dir = heartbeat_dir
        self.detectors = (detectors if detectors is not None
                          else default_detectors())
        self.live = live
        self.bus = bus if bus is not None else (events.get_bus()
                                                if live else None)
        self.out_dir = self._resolve_out_dir(out_dir)
        self.incidents: collections.deque = collections.deque(maxlen=256)
        self._history: collections.deque = collections.deque(
            maxlen=self.config.history_cap)
        self._active: dict[tuple[str, str], dict] = {}
        self._burns: dict[str, dict] = {}
        self._seq = itertools.count(1)
        self._tap: events.EventTap | None = None
        self._ring_dropped_prev = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        from prometheus_client import CollectorRegistry, Counter, Gauge
        self.registry = registry or CollectorRegistry()
        reg = self.registry
        self.incidents_total = Counter(
            "tpu_doctor_incidents",
            "Doctor incident bundles emitted, by verdict class",
            ["class"], registry=reg)
        self.burn_g = Gauge(
            "tpu_slo_burn_rate",
            "Error-budget burn rate per SLO and window (1.0 = budget "
            "consumed exactly at the sustainable rate)",
            ["slo", "window"], registry=reg)
        self.active_g = Gauge(
            "tpu_doctor_active_incidents",
            "Incident episodes currently firing", registry=reg)
        self.evals_total = Counter(
            "tpu_doctor_evals",
            "Doctor evaluation passes completed", registry=reg)
        # Materialize the class labels the e2e asserts on, so the
        # families scrape complete (all zeros) before anything fires.
        for det in self.detectors:
            self.incidents_total.labels(det.cls)

    @staticmethod
    def _resolve_out_dir(out_dir: str | None) -> str | None:
        if out_dir != "auto":
            return out_dir
        env = os.environ.get(DOCTOR_DIR_ENV)
        if env:
            return env
        dump = getattr(events, "_DUMP_PATH", None)
        if dump:
            return os.path.dirname(dump) or "."
        return "."

    # ---------- live loop ----------

    def start(self) -> None:
        """Subscribe the tap and start the poll thread (idempotent)."""
        if self._thread is not None:
            return
        if self._tap is None and self.bus is not None:
            self._tap = self.bus.subscribe("doctor")
            self._ring_dropped_prev = self.bus.dropped
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpu-doctor")
        self._thread.start()
        log.info("tpu-doctor running: %d detectors, poll %.1fs, "
                 "incident dir %s", len(self.detectors),
                 self.config.poll_interval_s, self.out_dir or "(none)")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("doctor evaluation failed")
            self._stop.wait(self.config.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._tap is not None and self.bus is not None:
            self.bus.unsubscribe(self._tap)
            self._tap = None

    # ---------- ingestion ----------

    def ingest(self, evs: list[dict]) -> None:
        """Append event dicts (already time-ordered) to the history.
        The doctor's own doctor/* emissions are excluded so a verdict
        never becomes its own evidence."""
        with self._lock:
            for e in evs:
                if not e["name"].startswith("doctor/"):
                    self._history.append(e)

    def _drain_tap(self) -> int:
        """Pull tap backlog into history; returns ring-drop delta since
        the previous poll (the blind-spot signal)."""
        dropped_delta = 0
        if self.bus is not None:
            d = self.bus.dropped
            dropped_delta = max(0, d - self._ring_dropped_prev)
            self._ring_dropped_prev = d
        if self._tap is not None:
            raw = self._tap.drain()
            if raw:
                self.ingest([_raw_to_dict(ev) for ev in raw])
        return dropped_delta

    # ---------- evaluation ----------

    def _signals(self, now: float, ring_dropped_delta: int) -> Signals:
        # Bounded both ways: below by the history horizon, above by
        # `now` — the replay clock must never let a detector see the
        # future (live events can't, monotonic ts <= monotonic now).
        horizon = now - self.config.slow_window_s * 1.5
        with self._lock:
            evs = [e for e in self._history
                   if horizon <= e["ts"] <= now]
        return Signals(now, evs, self.config,
                       request_recorder=self.request_recorder,
                       train_recorder=self.train_recorder,
                       health_source=self.health_source,
                       heartbeat_dir=self.heartbeat_dir,
                       ring_dropped_delta=ring_dropped_delta,
                       live=self.live)

    def poll_once(self, now: float | None = None) -> list[dict]:
        """One live evaluation: drain the tap, snapshot, diagnose.
        Returns incidents emitted by this pass."""
        dropped_delta = self._drain_tap()
        now = time.monotonic() if now is None else now
        return self.evaluate(self._signals(now, dropped_delta))

    def evaluate(self, sig: Signals) -> list[dict]:
        """Run the registry over one snapshot; dedup into episodes and
        emit incidents for new ones."""
        findings: list[Finding] = []
        for det in self.detectors:
            try:
                findings.extend(det.check(sig))
            except Exception:
                log.exception("detector %s failed", det.cls)
        self._refresh_burn_gauges(sig)

        emitted = []
        seen_keys = set()
        for f in findings:
            key = (f.cls, f.subject)
            seen_keys.add(key)
            ep = self._active.get(key)
            if ep is None:
                inc = self._emit_incident(f, sig)
                self._active[key] = {"since": sig.now,
                                     "last_seen": sig.now,
                                     "incident": inc}
                emitted.append(inc)
            else:
                ep["last_seen"] = sig.now
        for key in list(self._active):
            if key in seen_keys:
                continue
            if sig.now - self._active[key]["last_seen"] \
                    >= self.config.clear_after_s:
                del self._active[key]
                log.info("doctor: %s/%s cleared", *key)
                if self.live and events.enabled():
                    events.instant("doctor/clear", "doctor",
                                   {"class": key[0], "subject": key[1]})
        self.active_g.set(len(self._active))
        self.evals_total.inc()
        return emitted

    def _refresh_burn_gauges(self, sig: Signals) -> None:
        for spec in self.config.slos:
            fast, n_fast = slo_burn(sig, spec,
                                    self.config.fast_window_s)
            slow, n_slow = slo_burn(sig, spec,
                                    self.config.slow_window_s)
            self.burn_g.labels(slo=spec.name, window="fast").set(fast)
            self.burn_g.labels(slo=spec.name, window="slow").set(slow)
            self._burns[spec.name] = {
                "fast": round(fast, 3), "slow": round(slow, 3),
                "samples_fast": n_fast, "samples_slow": n_slow}

    # ---------- incident emission ----------

    def _emit_incident(self, f: Finding, sig: Signals) -> dict:
        confidence = f.confidence
        evidence = dict(f.evidence)
        if sig.ring_dropped_delta > 0:
            # Blind spot: the ring overwrote events since the last
            # evaluation, so the evidence may be incomplete — say so
            # in the verdict instead of pretending omniscience.
            evidence["ring_dropped_in_window"] = sig.ring_dropped_delta
            confidence = round(confidence * 0.8, 3)
        inc = {
            "kind": "tpu_doctor_incident",
            "version": 1,
            "seq": next(self._seq),
            "class": f.cls,
            "subject": f.subject,
            "summary": f.summary,
            "confidence": confidence,
            "t": round(time.time(), 3),
            "ts_monotonic": round(sig.now, 6),
            "pid": os.getpid(),
            "evidence": evidence,
            "slo_burn": dict(self._burns),
            "windows": {"fast_s": self.config.fast_window_s,
                        "slow_s": self.config.slow_window_s},
        }
        if self.bus is not None:
            inc["ring"] = {"emitted": self.bus.emitted,
                           "dropped": self.bus.dropped}
        inc["metrics"] = self._metric_snapshots()
        path = self._write_bundle(inc)
        if path:
            inc["bundle_path"] = path
        self.incidents.append(inc)
        self.incidents_total.labels(f.cls).inc()
        if self.live and events.enabled():
            events.instant(f"doctor/{f.cls}", "doctor",
                           {"subject": f.subject,
                            "summary": f.summary[:200],
                            "confidence": confidence,
                            "bundle": path or ""})
        log.error("tpu-doctor incident [%s] %s: %s%s", f.cls, f.subject,
                  f.summary,
                  f" (bundle -> {path})" if path else "")
        return inc

    def _metric_snapshots(self) -> dict:
        """Best-effort state-of-the-world attachments; each source is
        independently guarded (a broken snapshot must not lose the
        verdict)."""
        out: dict = {}
        rec = self.request_recorder
        if rec is not None:
            try:
                out["serve"] = {k: rec.pct_ms(k)
                                for k in ("ttft", "tpot", "queue_wait")}
            except Exception:
                log.exception("serve metric snapshot failed")
        trec = self.train_recorder
        if trec is not None:
            try:
                out["train"] = trec.summary()
                age = trec.last_step_age()
                if age is not None:
                    out["train"]["last_step_age_s"] = round(age, 3)
            except Exception:
                log.exception("train metric snapshot failed")
        if self.live:
            # The port builds its kernels once (kernels.build) and
            # compiles nothing at run time: the library's build record
            # stands where the JAX package attaches its compile cache.
            try:
                from container_engine_accelerators_tpu_torch import kernels
                out["compile_cache"] = kernels.build_record()
            except Exception:
                log.exception("compile snapshot failed")
        return out

    def _write_bundle(self, inc: dict) -> str | None:
        """Atomic (tmp + os.replace) incident bundle write; never
        raises — diagnosis must not take down the patient."""
        if not self.out_dir:
            return None
        try:
            path = os.path.join(
                self.out_dir,
                f"incident-{inc['class']}-{os.getpid()}"
                f"-{inc['seq']}.json")
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(inc, fh)
            os.replace(tmp, path)
            return path
        except Exception:
            log.exception("incident bundle write failed")
            return None

    # ---------- introspection ----------

    def debugz(self) -> dict:
        with self._lock:
            history_len = len(self._history)
        tap = self._tap
        return {
            "active": True,
            "config": self.config.summary(),
            "detectors": [d.cls for d in self.detectors],
            "active_incidents": [
                {"class": k[0], "subject": k[1],
                 "since": round(v["since"], 3),
                 "last_seen": round(v["last_seen"], 3)}
                for k, v in self._active.items()],
            "incidents": list(self.incidents)[-32:],
            "slo_burn": dict(self._burns),
            "history_events": history_len,
            "tap": ({"received": tap.received, "dropped": tap.dropped}
                    if tap is not None else None),
        }


# ---------- offline replay ----------

def replay(trace: dict, config: DoctorConfig | None = None,
           step_s: float | None = None, out_dir: str | None = None,
           request_recorder=None, train_recorder=None) -> list[dict]:
    """Run the detector registry over a merged timeline (or a raw
    dump): the clock is stepped from the first event to the last in
    `step_s` increments (default: the config poll interval), each step
    evaluating exactly like a live poll. One deduplicated incident per
    fault episode comes out, same as live — the property the chaos
    harness's 'the system names the fault' assertions rest on."""
    config = config or DoctorConfig()
    evs = trace_to_events(trace)
    doc = Doctor(config=config, out_dir=out_dir, bus=None, live=False,
                 request_recorder=request_recorder,
                 train_recorder=train_recorder)
    if not evs:
        return []
    doc.ingest(evs)
    step = step_s or config.poll_interval_s
    t0, t1 = evs[0]["ts"], evs[-1]["ts"]
    t = t0 + step
    while t <= t1 + step:
        doc.evaluate(doc._signals(min(t, t1), 0))
        t += step
    return list(doc.incidents)


# ---------- process-wide active doctor (for /debugz) ----------

_ACTIVE: Doctor | None = None


def set_active(doc: Doctor | None) -> None:
    global _ACTIVE
    _ACTIVE = doc


def get_active() -> Doctor | None:
    return _ACTIVE


# ---------- chaos fault listener (cli/inject_fault.py --kind ...) ----------

class FaultListener:
    """Tails a JSONL fault-command file and trips real failure modes
    in this process — the injection half the detectors are tested
    against. Records ({"kind": ..., params}) are appended by
    `inject_fault --kind hang|worker-kill|hbm-climb|... --fault-log
    PATH`; serve and train arm the listener with `--fault-listen PATH`
    (chaos/test runs only — injection is a deliberately sharp tool).

      hang             {"seconds": S}: the engine worker sleeps S at
                       its next loop top (slots stay occupied, no
                       ticks — a REAL hang, not a simulated one;
                       cli/serve.py _maybe_injected_hang)
      worker_kill      {}: the engine worker thread raises
                       WorkerKilled at its next loop top and DIES with
                       in-flight work abandoned — the failure mode
                       `serve --supervise` recovers from (structured
                       errors, slot/page reclaim, backoff restart)
      prefill_kill     {}: ONE prefill-pool worker dies at its next
                       loop top (`serve --prefill-workers`)
      recompile_storm  {"n": N}: no counterpart in the port, which
                       compiles nothing at run time; logged and
                       otherwise inert
      hbm_climb        {"device", "seconds", "start_frac", "end_frac",
                       "limit"}: fabricated hbm/<device> counter climb
      queue_collapse   {"depth", "seconds"}: fabricated queue-depth
                       growth with zero admits
      data_stall       {"seconds": S}: the NEXT data-loader batch
                       fetch sleeps S inside the iterator
                       (training/dataset.py stall hook) — real
                       data-wait, charged to the stalled goodput
                       bucket
      straggler        {"delay_s": D, "seconds": S}: EVERY batch fetch
                       sleeps D for the next S seconds — this process
                       becomes the slow rank the watchdog/doctor must
                       name
      health_tail      {"path": P, "seconds": S}: run a REAL
                       TPUHealthChecker over a LogFileErrorSource
                       tailing P for S seconds, so records appended by
                       `inject_fault --kind health --error-log P`
                       flow through the production health pipeline
                       (health/<class> instants, scrape counters) in
                       THIS process
      fabric_slow      no counterpart in the port (no fabric monitor is
                       ported); logged and otherwise inert

    Every kind, inert or not, lands a `fault/injected` instant first.
    """

    def __init__(self, path: str, engine=None, interval_s: float = 0.25):
        from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (  # noqa: E501
            _TailReader,
        )
        self.path = path
        self.engine = engine
        self.interval_s = interval_s
        self._tail = _TailReader(path)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fault-listener")
        self._thread.start()
        log.warning("FAULT INJECTION armed: listening on %s", self.path)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            for line in self._tail.read_lines():
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    log.warning("malformed fault record: %r", line)
                    continue
                try:
                    self._apply(rec)
                except Exception:
                    log.exception("fault injection %r failed", rec)
            self._stop.wait(self.interval_s)

    def _apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        log.warning("injecting fault: %r", rec)
        if events.enabled():
            events.instant("fault/injected", "chaos", {"kind": kind})
        if kind == "hang":
            if self.engine is None:
                log.warning("hang fault with no engine attached")
                return
            self.engine.fault_hang_s = float(rec.get("seconds", 5.0))
        elif kind == "worker_kill":
            if self.engine is None:
                log.warning("worker-kill fault with no engine attached")
                return
            self.engine.fault_kill = True
        elif kind == "prefill_kill":
            if self.engine is None:
                log.warning("prefill-kill fault with no engine attached")
                return
            # Consumed by ONE prefill-pool worker at its next loop top
            # (cli/serve.py _prefill_worker) — outside the engine lock,
            # so the death never strands _mu or half-mutated pages.
            self.engine.fault_kill_prefill = True
        elif kind == "recompile_storm":
            log.warning("recompile_storm fault trips nothing here: the "
                        "port builds its kernels once and compiles "
                        "nothing at run time, so no xla/recompile event "
                        "can be provoked")
        elif kind == "hbm_climb":
            self._hbm_climb(rec)
        elif kind == "queue_collapse":
            self._queue_collapse(rec)
        elif kind == "data_stall":
            from container_engine_accelerators_tpu_torch.training.dataset import (
                inject_stall,
            )
            inject_stall(once_s=float(rec.get("seconds", 3.0)))
        elif kind == "straggler":
            from container_engine_accelerators_tpu_torch.training.dataset import (
                inject_stall,
            )
            inject_stall(per_batch_s=float(rec.get("delay_s", 1.0)),
                         duration_s=float(rec.get("seconds", 10.0)))
        elif kind == "health_tail":
            self._health_tail(rec)
        elif kind == "fabric_slow":
            from container_engine_accelerators_tpu_torch.metrics import (
                fabric_health,
            )
            fabric_health.inject_slow(
                axis=str(rec.get("axis", "dp")),
                rank=int(rec.get("rank", 0)),
                factor=float(rec.get("factor", 8.0)),
                seconds=float(rec.get("seconds", 60.0)),
                delay_s=float(rec.get("delay_s", 0.02)))
        else:
            log.warning("unknown fault kind %r", kind)

    def _hbm_climb(self, rec: dict) -> None:
        device = rec.get("device", "injected:0")
        seconds = float(rec.get("seconds", 3.0))
        limit = int(rec.get("limit", 16 * 2 ** 30))
        start = float(rec.get("start_frac", 0.5))
        end = float(rec.get("end_frac", 0.97))
        samples = max(4, int(rec.get("samples", 8)))
        for i in range(samples):
            frac = start + (end - start) * i / (samples - 1)
            events.counter(f"hbm/{device}",
                           {"bytes_in_use": int(limit * frac),
                            "bytes_limit": limit}, "hbm")
            if self._stop.wait(seconds / samples):
                return

    def _queue_collapse(self, rec: dict) -> None:
        depth = int(rec.get("depth", 8))
        seconds = float(rec.get("seconds", 3.0))
        samples = max(2, depth)
        for i in range(samples):
            events.counter("serve/queue_depth",
                           {"queued": 1 + i * depth // samples}, "serve")
            if self._stop.wait(seconds / samples):
                return

    def _health_tail(self, rec: dict) -> None:
        """Run the REAL health pipeline over an injected error feed:
        a TPUHealthChecker with a LogFileErrorSource tails `path` for
        `seconds`, so `inject_fault --kind health --error-log <path>`
        records produce genuine ErrorEvents — health/<class> bus
        instants, scrape counters, error_summary() — in this process
        (the chaos health-storm scenario's detection surface). No K8s,
        no device manager: chip-health flips are no-ops here, the
        observability side is what the storm exercises."""
        from container_engine_accelerators_tpu_torch.deviceplugin.config import (
            TPUConfig,
        )
        from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (  # noqa: E501
            LogFileErrorSource,
            TPUHealthChecker,
        )

        class _NullManager:
            devices: dict = {}

            def set_device_health(self, *a, **k):
                pass

            def set_chip_health(self, *a, **k):
                pass

        path = rec.get("path")
        if not path:
            log.warning("health_tail fault without a path")
            return
        seconds = float(rec.get("seconds", 5.0))
        interval = float(rec.get("interval", 0.2))
        checker = TPUHealthChecker(
            _NullManager(), TPUConfig(),
            sources=[LogFileErrorSource(path)], k8s=None)
        # The reboot-reset path runs first like the real poll loop
        # (a no-op without k8s; the unit tests pin its attempt cap).
        checker.maybe_reset_condition()
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            checker.poll_once()
            if self._stop.wait(interval):
                return
        log.warning("health_tail done: %s", checker.error_summary())
