"""Request-lifecycle metrics for the serving engines.

One `RequestRecorder` is shared by every engine in `cli/serve.py`; the
engines call it at each lifecycle edge:

    enqueue -> admit -> first_token -> decode_token* -> finish
                  \\-> preempt (paged engine, back to enqueue)
                  \\-> fail (device error / admission failure)

and it turns those edges into Prometheus histograms (TTFT, TPOT, queue
wait, prefill time, decode step time), gauges (queue depth, active
slots, KV page occupancy, KV thermal buckets, host-gap fraction) and
counters (requests by outcome, preemptions, validation failures, engine
resets, prefix lookups, worker restarts, speculative drafts and
acceptances) on a private `CollectorRegistry`, served over
HTTP by `ServeMetricsExporter` (`serve --metrics-port`; port 0 binds an
ephemeral port). Metric names, labels and buckets are the JAX
package's, so one dashboard reads a scrape of either.

The recorder also keeps the raw samples (bounded deques), so offline
harnesses (chip_smoke.py's observe phase) derive p50/p95/p99 from the
same observations the scrape exports.

`state_snapshot()` publishes the routing inputs (queue depth, KV-page
headroom, prefix hit rate) and rolling SLO windows as one dict, served
on `/debugz?state=1` for the fleet scraper (metrics/fleet.py);
`window_counts()` feeds the doctor's SLO burn engine
(metrics/doctor.py).

All methods take an optional `now` (monotonic seconds) so tests can
drive a synthetic timeline; production callers omit it. Thread-safe:
submit runs on HTTP threads while the worker loop observes tokens.

Semantics worth pinning:
  - TTFT is measured from ENQUEUE (what a client experiences), prefill
    time from ADMIT (what the engine controls); queue wait is the gap.
  - The window engine materializes tokens only at batch completion, so
    it observes TTFT at completion and amortizes TPOT as
    batch_time / new_tokens (via `observe_tpot`) — degenerate but
    honest, and the observation COUNTS stay identical across engines.
  - A preemption re-queues the request: queue wait and TTFT are
    observed again for the re-admission (time to first token after
    restart), matching what the client's stream shows.
"""

from __future__ import annotations

import collections
import math
import threading
import time

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

from container_engine_accelerators_tpu_torch.metrics import events, trace
from container_engine_accelerators_tpu_torch.metrics.serving import (
    ExporterBase,
)

# Spans the tiny-model CPU tests (~1 ms steps) through real serving
# (multi-second TTFT under load); decode steps sit 1-2 orders below
# request latencies, hence the separate finer ladder.
_REQ_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5,
                1.0, 2.5, 5.0, 10.0, 30.0)
_STEP_BUCKETS = (.0001, .00025, .0005, .001, .0025, .005, .01, .025,
                 .05, .1, .25, .5, 1.0)

SAMPLE_KINDS = ("ttft", "tpot", "queue_wait", "prefill", "decode_step")

# Named host-side phases of one engine tick. "admit" is request
# admission, "schedule" covers the prefill chunk, page growth and the
# dispatch call itself, "sample" is the token pick's bookkeeping,
# "stream" is SSE fan-out plus recorder updates, "fetch" is the one
# blocking device->host transfer. Each observation is flagged hidden
# (ran under an in-flight device tick) or exposed (device idle while the
# host worked); the ratio of exposed host time to wall time is
# `host_gap_fraction`.
HOST_PHASES = ("admit", "schedule", "sample", "stream", "fetch")

# Rolling SLO window published by state_snapshot() for the fleet
# scraper. The thresholds mirror doctor.default_slos() (ttft_p99 2.0 s,
# tpot_p99 0.25 s) but stay local constants: the snapshot path must not
# import the detector stack.
STATE_SLO_WINDOW_S = 60.0
STATE_SLO_TTFT_S = 2.0
STATE_SLO_TPOT_S = 0.25


def percentile(xs, p):
    """Nearest-rank percentile (inclusive): the smallest sample with at
    least p% of the mass at or below it. None on empty input."""
    if not xs:
        return None
    xs = sorted(xs)
    k = max(0, math.ceil(p / 100.0 * len(xs)) - 1)
    return xs[min(k, len(xs) - 1)]


def percentiles(xs, ps=(50, 95, 99)):
    """{"p50": ..., "p95": ..., "p99": ...} via nearest-rank."""
    return {f"p{p}": percentile(xs, p) for p in ps}


class RequestRecorder:
    """Thread-safe lifecycle recorder; see the module docstring for the
    edge protocol and measurement semantics."""

    def __init__(self, registry: CollectorRegistry | None = None,
                 max_samples: int = 65536):
        self.registry = registry or CollectorRegistry()
        self._lock = threading.Lock()
        # rid -> {"stage", "enqueue_ts", "admit_ts", "last_tok_ts"}
        self._state: dict = {}
        self._queued = 0
        self.samples = {k: collections.deque(maxlen=max_samples)
                        for k in SAMPLE_KINDS}
        # Timestamped twin of `samples` ((monotonic ts, value)), so
        # windowed consumers (the doctor's multi-window SLO burn engine)
        # can count threshold violations over "the last N seconds"
        # instead of "the last N samples".
        self.timed = {k: collections.deque(maxlen=max_samples)
                      for k in SAMPLE_KINDS}
        # Host-phase attribution: per-phase durations kept
        # apart from SAMPLE_KINDS so histogram-driven consumers are
        # untouched, plus a rolling (exposed_s, wall_s) window per tick
        # from which host_gap_fraction is derived.
        self.host_samples = {p: collections.deque(maxlen=max_samples)
                             for p in HOST_PHASES}
        self._host_ticks = collections.deque(maxlen=4096)
        self._host_exposed = 0.0    # sums over _host_ticks
        self._host_wall = 0.0

        reg = self.registry
        self.ttft = Histogram(
            "serve_ttft_seconds",
            "Time from enqueue to the request's first generated token",
            buckets=_REQ_BUCKETS, registry=reg)
        self.tpot = Histogram(
            "serve_tpot_seconds",
            "Time per generated token after the first (inter-token gap)",
            buckets=_STEP_BUCKETS, registry=reg)
        self.queue_wait = Histogram(
            "serve_queue_wait_seconds",
            "Time from enqueue to admission into a decode slot/batch",
            buckets=_REQ_BUCKETS, registry=reg)
        self.prefill = Histogram(
            "serve_prefill_seconds",
            "Time from admission to the first generated token",
            buckets=_REQ_BUCKETS, registry=reg)
        self.decode_step = Histogram(
            "serve_decode_step_seconds",
            "Latency of one decode step over the whole active batch",
            buckets=_STEP_BUCKETS, registry=reg)

        self.queue_depth = Gauge(
            "serve_queue_depth",
            "Requests enqueued or backlogged, not yet in a slot",
            registry=reg)
        self.active_slots = Gauge(
            "serve_active_slots", "Decode slots holding a live request",
            registry=reg)
        self.slots_total = Gauge(
            "serve_slots_total", "Configured decode slots", registry=reg)
        self.kv_pages_in_use = Gauge(
            "serve_kv_pages_in_use",
            "KV pool pages held by live slots or the prefix cache "
            "(paged engine)", registry=reg)
        self.kv_pages_total = Gauge(
            "serve_kv_pages_total",
            "Usable KV pool pages, excluding the reserved trash row "
            "(paged engine)", registry=reg)
        self.prefix_cache_pages = Gauge(
            "serve_prefix_cache_pages",
            "Distinct KV pool pages retained by the prefix cache; "
            "after a drain, kv_pages_in_use minus this must be zero "
            "(the leak invariant)", registry=reg)
        self.pool_queue_depth = Gauge(
            "serve_pool_queue_depth",
            "Per-pool work depth in the disaggregated layout "
            "(serve --prefill-workers): prefill = backlogged requests "
            "plus slots still holding prompt tokens, decode = slots "
            "ticking", ["pool"], registry=reg)
        self.host_gap_fraction = Gauge(
            "serve_host_gap_fraction",
            "Fraction of engine wall time spent in host-side work NOT "
            "hidden under an in-flight device tick (rolling window). "
            "Near zero when the async double-buffered core keeps "
            "admission/scheduling/streaming under device execution; "
            "approaches the full host slice on the synchronous path",
            registry=reg)
        self.prefix_hit_rate = Gauge(
            "serve_prefix_hit_rate",
            "prefix_hits / prefix_lookups over this process's "
            "lifetime (paged engine)", registry=reg)
        # KV thermal families: fed by the engine's periodic
        # PageAllocator.thermal_census() via set_kv_thermal().
        self.kv_pages_by_temperature = Gauge(
            "serve_kv_pages_by_temperature",
            "KV pool pages by idle-time bucket (hot/warm/cold under "
            "the engine's thermal thresholds; active-slot pages are "
            "pinned hot)", ["bucket"], registry=reg)
        self.kv_working_set_pages = Gauge(
            "serve_kv_working_set_pages",
            "Working-set-size estimate in pages (p90 sampled reuse "
            "distance + 1; falls back to the recently-touched set "
            "before any reuse is observed)", registry=reg)
        self.kv_tenant_pages = Gauge(
            "serve_kv_tenant_pages",
            "KV pool pages attributed to each tenant (first-owner "
            "attribution; 'unowned' = no tenant tag on the admitting "
            "request)", ["tenant"], registry=reg)
        self.kv_page_idle = Histogram(
            "serve_kv_page_idle_seconds",
            "Per-page idle time at census (seconds since last host "
            "touch; active-slot pages report 0)",
            buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0,
                     300.0, 600.0), registry=reg)

        self.requests = Counter(
            "serve_requests", "Requests closed, by outcome",
            ["outcome"], registry=reg)
        self.preemptions = Counter(
            "serve_preemptions",
            "Requests preempted (pages freed, requeued with progress)",
            registry=reg)
        self.validation_failures = Counter(
            "serve_validation_failures",
            "Requests rejected before enqueue (bad prompt/params)",
            registry=reg)
        self.engine_resets = Counter(
            "serve_engine_resets",
            "Device-error recoveries that rebuilt the KV pool and "
            "failed all in-flight work", registry=reg)
        self.prefix_pages_reused = Counter(
            "serve_prefix_pages_reused",
            "Full prompt pages served from the prefix cache instead of "
            "recomputed (paged engine)", registry=reg)
        # Lookup/hit/miss make the cache's effectiveness computable:
        # reused-page counts alone can't tell "never asked" from "asked
        # and missed".
        self.prefix_lookups = Counter(
            "serve_prefix_lookups",
            "Prefix-cache lookups at paged admission (prompts with at "
            "least one full page)", registry=reg)
        self.prefix_hits = Counter(
            "serve_prefix_hits",
            "Prefix-cache lookups that matched at least one full "
            "prompt page", registry=reg)
        self.prefix_misses = Counter(
            "serve_prefix_misses",
            "Prefix-cache lookups that matched nothing", registry=reg)
        self.prefill_chunks = Counter(
            "serve_prefill_chunks",
            "Prompt chunks forwarded by the prefill path (its progress "
            "signal)",
            registry=reg)
        self.worker_restarts = Counter(
            "serve_worker_restarts",
            "Engine worker threads restarted by the supervisor after an "
            "unexpected death (serve --supervise)", registry=reg)
        self.prefill_worker_restarts = Counter(
            "serve_prefill_worker_restarts",
            "Prefill-pool workers replaced by the supervisor after an "
            "unexpected death (serve --prefill-workers --supervise); "
            "partial recovery — no request fails", registry=reg)
        # Speculative decoding: one "verify" is one slot scored in one
        # verify pass (a pass over 4 slots counts 4), so tokens per
        # verify is the per-request speedup, not a batch-size artifact.
        self.spec_drafted = Counter(
            "serve_spec_drafted_tokens",
            "Draft tokens proposed to the verifier", registry=reg)
        self.spec_accepted = Counter(
            "serve_spec_accepted_tokens",
            "Draft tokens accepted by greedy verification (excludes "
            "the bonus token every verify pass yields)", registry=reg)
        self.spec_verifies = Counter(
            "serve_spec_verifies",
            "Slot-verify passes (one per active slot per speculative "
            "tick)", registry=reg)
        self.spec_committed = Counter(
            "serve_spec_committed_tokens",
            "Tokens emitted by speculative ticks (accepted drafts plus "
            "bonus tokens, after caps)", registry=reg)
        self.spec_acceptance_rate = Gauge(
            "serve_spec_acceptance_rate",
            "accepted / drafted over this process's lifetime",
            registry=reg)
        self.spec_tokens_per_verify = Gauge(
            "serve_spec_tokens_per_verify",
            "committed tokens per verify pass (1.0 = speculation is "
            "pure overhead; k+1 = every draft accepted)", registry=reg)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_verifies = 0
        self._spec_committed = 0
        self._prefix_lookups = 0
        self._prefix_hits = 0
        # Shadow copies of the occupancy gauges (prometheus Gauges are
        # write-only from here), so state_snapshot() can publish them
        # machine-readably for the fleet scraper.
        self._last_slots = (0, 0)
        self._last_kv = (0, 0)
        self._last_pools = (0, 0)
        self._last_prefix_pages = 0
        self._last_thermal: dict | None = None

    # ---------- lifecycle edges ----------

    def _observe(self, kind: str, value: float,
                 now: float | None = None) -> None:
        value = max(value, 0.0)
        getattr(self, kind).observe(value)  # histogram attrs match kinds
        self.samples[kind].append(value)
        self.timed[kind].append(
            (time.monotonic() if now is None else now, value))

    def enqueue(self, rid, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._state[rid] = {"stage": "queued", "enqueue_ts": now}
            self._queued += 1
            self.queue_depth.set(self._queued)
            # Flight-recorder edges (metrics/events.py): the request
            # becomes one async span on the merged timeline. Guarded so
            # the disabled path builds no args dict.
            if events.enabled():
                events.async_begin("request", rid, "serve")
                events.counter("serve/queue_depth",
                               {"queued": self._queued})
            # Per-request trace: the queue span opens here.
            # `start` is idempotent — engines that started the trace
            # with force/tags in submit() get their handle back.
            h = trace.start(rid)
            if h is not None:
                h.begin(trace.SPAN_QUEUE, ts=now)

    def admit(self, rid, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._state.get(rid)
            if st is None:  # recorder attached mid-flight: adopt
                st = self._state[rid] = {"stage": "queued",
                                         "enqueue_ts": now}
                self._queued += 1
            if st["stage"] == "queued":
                self._queued -= 1
                self.queue_depth.set(self._queued)
            st["stage"] = "active"
            st["admit_ts"] = now
            self._observe("queue_wait", now - st["enqueue_ts"], now)
            if events.enabled():
                events.async_instant("admit", rid, "serve")
                events.counter("serve/queue_depth",
                               {"queued": self._queued})
            h = trace.handle(rid)
            if h is not None:
                h.end(trace.SPAN_QUEUE, ts=now)
                h.begin(trace.SPAN_PREFILL, ts=now)

    def first_token(self, rid, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._state.get(rid)
            if st is None:
                return
            ttft = now - st["enqueue_ts"]
            self._observe("ttft", ttft, now)
            if "admit_ts" in st:
                self._observe("prefill", now - st["admit_ts"], now)
            st["last_tok_ts"] = now
            if events.enabled():
                events.async_instant("first_token", rid, "serve")
            h = trace.handle(rid)
            if h is not None:
                tr = trace.get()
                h.note_ttft(ttft * 1e3,
                            tr.slo_ttft_ms if tr else None)
                h.end(trace.SPAN_PREFILL, ts=now)

    def decode_token(self, rid, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._state.get(rid)
            if st is None or "last_tok_ts" not in st:
                return
            tpot = now - st["last_tok_ts"]
            self._observe("tpot", tpot, now)
            st["last_tok_ts"] = now
            h = trace.handle(rid)
            if h is not None:
                tr = trace.get()
                h.note_tpot(tpot * 1e3,
                            tr.slo_tpot_ms if tr else None)

    def observe_tpot(self, seconds: float) -> None:
        """Direct TPOT observation for engines with no incremental
        tokens (the window engine amortizes the batch time)."""
        with self._lock:
            self._observe("tpot", seconds)

    def observe_decode_step(self, seconds: float) -> None:
        with self._lock:
            self._observe("decode_step", seconds)
            if events.enabled():
                events.counter("serve/decode_step_ms",
                               {"ms": round(seconds * 1e3, 3)})

    def preempt(self, rid, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._state.get(rid)
            if st is None:
                return
            self.preemptions.inc()
            if st["stage"] == "active":
                self._queued += 1
                self.queue_depth.set(self._queued)
            st["stage"] = "queued"
            st["enqueue_ts"] = now
            st.pop("admit_ts", None)
            st.pop("last_tok_ts", None)
            if events.enabled():
                events.async_instant("preempt", rid, "serve")
                events.counter("serve/queue_depth",
                               {"queued": self._queued})
            h = trace.handle(rid)
            if h is not None:
                # Preemption promotes the trace out of the tail buffer
                # and re-opens the queue span for the requeue wait.
                h.promote("preempt")
                h.instant(trace.EV_PREEMPT, ts=now)
                h.begin(trace.SPAN_QUEUE, {"requeue": True}, ts=now)

    def finish(self, rid) -> None:
        self._close(rid, "ok")

    def fail(self, rid) -> None:
        self._close(rid, "error")

    def _close(self, rid, outcome: str) -> None:
        with self._lock:
            st = self._state.pop(rid, None)
            if st is None:
                return  # never enqueued (validation) or already closed
            if st["stage"] == "queued":
                self._queued -= 1
                self.queue_depth.set(self._queued)
            self.requests.labels(outcome=outcome).inc()
            if events.enabled():
                events.async_end("request", rid, "serve",
                                 {"outcome": outcome})
            # Tail-sampling decision point: failed / preempted / SLO-
            # violating requests flush their buffered spans here.
            trace.finish(rid, outcome)

    # ---------- occupancy gauges (set by the worker loop) ----------

    def set_slots(self, active: int, total: int) -> None:
        self._last_slots = (active, total)
        self.active_slots.set(active)
        self.slots_total.set(total)
        if events.enabled():
            events.counter("serve/slots", {"active": active,
                                           "total": total})

    def set_kv_pages(self, used: int, total: int) -> None:
        self._last_kv = (used, total)
        self.kv_pages_in_use.set(used)
        self.kv_pages_total.set(total)
        if events.enabled():
            events.counter("serve/kv_pages", {"used": used,
                                              "total": total})

    def set_prefix_cache_pages(self, pages: int) -> None:
        self._last_prefix_pages = pages
        self.prefix_cache_pages.set(pages)

    def set_kv_thermal(self, census: dict) -> None:
        """Publish one PageAllocator.thermal_census() snapshot: the
        temperature/WSS/tenant gauge families, the per-page idle
        histogram, the flight-recorder counter tracks the doctor's
        kv_cold_waste detector reads, and the state_snapshot() shadow
        the fleet scraper rolls up."""
        buckets = census.get("buckets") or {}
        tenants = census.get("tenants") or {}
        wss = census.get("working_set_pages")
        with self._lock:
            self._last_thermal = {
                "buckets": {b: int(buckets.get(b, 0))
                            for b in ("hot", "warm", "cold")},
                "working_set_pages": wss,
                "cold_evictable": census.get("cold_evictable"),
                "cold_orphan": census.get("cold_orphan"),
                "tenants": {t: int(info.get("pages", 0))
                            for t, info in tenants.items()},
                "tenants_cold": {t: int(info.get("cold", 0))
                                 for t, info in tenants.items()},
            }
        for b in ("hot", "warm", "cold"):
            self.kv_pages_by_temperature.labels(bucket=b).set(
                buckets.get(b, 0))
        if wss is not None:
            self.kv_working_set_pages.set(wss)
        for t, info in tenants.items():
            self.kv_tenant_pages.labels(tenant=str(t)).set(
                info.get("pages", 0))
        for v in census.get("idle_values") or ():
            self.kv_page_idle.observe(v)
        if events.enabled():
            events.counter("serve/kv_thermal", {
                "hot": buckets.get("hot", 0),
                "warm": buckets.get("warm", 0),
                "cold": buckets.get("cold", 0),
                "wss": wss or 0,
            })
            tenant_cold = {str(t): int(info.get("cold", 0))
                           for t, info in tenants.items()}
            if tenant_cold:
                events.counter("serve/kv_tenant_cold", tenant_cold)

    def set_pool_depths(self, prefill: int, decode: int) -> None:
        """Per-pool depth gauges (disaggregated layout); the twin
        flight-recorder counter is what the doctor's two-queue
        queue_collapse detector reads (metrics/doctor.py)."""
        self._last_pools = (prefill, decode)
        self.pool_queue_depth.labels(pool="prefill").set(prefill)
        self.pool_queue_depth.labels(pool="decode").set(decode)
        if events.enabled():
            events.counter("serve/pool_depth", {"prefill": prefill,
                                                "decode": decode})

    # ---------- prefix cache / prefill progress ----------

    def prefix_lookup(self, hit: bool) -> None:
        """One prefix-cache lookup at admission; keeps the hit-rate
        gauge consistent with the counters under one lock."""
        with self._lock:
            self._prefix_lookups += 1
            self.prefix_lookups.inc()
            if hit:
                self._prefix_hits += 1
                self.prefix_hits.inc()
            else:
                self.prefix_misses.inc()
            self.prefix_hit_rate.set(
                self._prefix_hits / self._prefix_lookups)

    def observe_spec(self, drafted: int, accepted: int, verifies: int,
                     committed: int) -> None:
        """One speculative verify tick: `drafted` and `accepted` draft
        tokens over `verifies` slot-verify passes, emitting `committed`
        tokens. The counters and the derived gauges move together under
        one lock, so a scrape never sees a torn ratio."""
        with self._lock:
            self._spec_drafted += drafted
            self._spec_accepted += accepted
            self._spec_verifies += verifies
            self._spec_committed += committed
            self.spec_drafted.inc(drafted)
            self.spec_accepted.inc(accepted)
            self.spec_verifies.inc(verifies)
            self.spec_committed.inc(committed)
            if self._spec_drafted:
                self.spec_acceptance_rate.set(
                    self._spec_accepted / self._spec_drafted)
            if self._spec_verifies:
                self.spec_tokens_per_verify.set(
                    self._spec_committed / self._spec_verifies)
            if events.enabled():
                events.counter("serve/spec", {
                    "drafted": self._spec_drafted,
                    "accepted": self._spec_accepted})

    # ---------- host-gap attribution ----------

    def observe_host_phase(self, phase: str, seconds: float,
                           hidden: bool = False) -> None:
        """One named host-phase slice of an engine tick. `hidden` means
        the slice ran while a dispatched-but-unfetched device tick was
        outstanding, i.e. the host work cost no device idle time."""
        with self._lock:
            self.host_samples[phase].append(
                (max(seconds, 0.0), bool(hidden)))

    def observe_host_tick(self, exposed_s: float,
                          wall_s: float) -> None:
        """One engine tick's exposure accounting: `exposed_s` of host
        time the device sat idle for, out of `wall_s` total. Feeds the
        rolling host_gap_fraction gauge."""
        with self._lock:
            if wall_s <= 0:
                return
            ticks = self._host_ticks
            if len(ticks) == ticks.maxlen:   # the oldest leaves the window
                e0, w0 = ticks[0]
                self._host_exposed -= e0
                self._host_wall -= w0
            e, w = max(exposed_s, 0.0), float(wall_s)
            ticks.append((e, w))
            # Running sums, so a tick costs O(1), not a pass over the
            # window on the engine thread.
            self._host_exposed += e
            self._host_wall += w
            self.host_gap_fraction.set(
                min(self._host_exposed / self._host_wall, 1.0))

    def host_gap(self) -> float | None:
        """Rolling exposed-host / wall fraction; None before any tick
        has been observed."""
        with self._lock:
            if not self._host_ticks:
                return None
            return min(self._host_exposed / self._host_wall, 1.0)

    def host_phase_ms(self, ps=(50, 95, 99)) -> dict:
        """{phase: {"p50": ms, ...}} over retained per-phase samples
        (hidden and exposed alike — attribution, not exposure)."""
        with self._lock:
            snap = {p: [s for s, _ in self.host_samples[p]]
                    for p in HOST_PHASES}
        return {p: {k: round(v * 1e3, 4)
                    for k, v in percentiles(xs, ps).items()
                    if v is not None}
                for p, xs in snap.items() if xs}

    def observe_prefill_chunk(self, tokens: int) -> None:
        """One forwarded prompt chunk: the prefill path's progress
        heartbeat."""
        self.prefill_chunks.inc()
        if events.enabled():
            events.counter("serve/prefill_chunk_tokens",
                           {"tokens": tokens})

    # ---------- offline summaries ----------

    def pct(self, kind: str, ps=(50, 95, 99)) -> dict:
        """Nearest-rank percentiles (seconds) over retained samples."""
        with self._lock:
            xs = list(self.samples[kind])
        return percentiles(xs, ps)

    def pct_ms(self, kind: str, ps=(50, 95, 99)) -> dict:
        """Same, in rounded milliseconds (None entries dropped)."""
        return {k: round(v * 1e3, 3)
                for k, v in self.pct(kind, ps).items() if v is not None}

    def window_counts(self, kind: str, since: float,
                      threshold: float | None = None
                      ) -> tuple[int, int]:
        """(observations, observations over `threshold`) among samples
        with monotonic ts >= `since`: the windowed error-rate input the
        doctor's SLO burn engine consumes (metrics/doctor.py)."""
        with self._lock:
            pts = [v for ts, v in self.timed[kind] if ts >= since]
        if threshold is None:
            return len(pts), 0
        return len(pts), sum(1 for v in pts if v > threshold)

    # ---------- fleet state snapshot ----------

    def state_snapshot(self, now: float | None = None) -> dict:
        """Machine-readable engine-state snapshot for the fleet scraper,
        served on /debugz?state=1 (metrics/serving.py `state_provider`):
        the routing inputs (queue depth, KV-page headroom, prefix hit
        rate) plus the rolling SLO windows the fleet_slo_burn detector
        aggregates across replicas. The keys are the JAX package's."""
        now = time.monotonic() if now is None else now
        with self._lock:
            queued = self._queued
            active, total = self._last_slots
            kv_used, kv_total = self._last_kv
            prefill_d, decode_d = self._last_pools
            prefix_pages = self._last_prefix_pages
            lookups, hits = self._prefix_lookups, self._prefix_hits
            thermal = self._last_thermal
        since = now - STATE_SLO_WINDOW_S
        ttft_n, ttft_bad = self.window_counts("ttft", since,
                                              STATE_SLO_TTFT_S)
        tpot_n, tpot_bad = self.window_counts("tpot", since,
                                              STATE_SLO_TPOT_S)
        out = {
            # An epoch stamp for cross-process alignment, not a duration.
            "t": round(time.time(), 3),
            "ts_monotonic": round(now, 6),
            "queued": queued,
            "slots": {"active": active, "total": total},
            "kv_pages": {"used": kv_used, "total": kv_total,
                         "headroom": max(kv_total - kv_used, 0)},
            "prefix_cache": {"lookups": lookups, "hits": hits,
                             "hit_rate": (hits / lookups
                                          if lookups else None),
                             "pages": prefix_pages},
            "pool_depth": {"prefill": prefill_d, "decode": decode_d},
            "host_gap_fraction": self.host_gap(),
            "slo_windows": {
                "window_s": STATE_SLO_WINDOW_S,
                "ttft": {"n": ttft_n, "bad": ttft_bad,
                         "threshold_s": STATE_SLO_TTFT_S},
                "tpot": {"n": tpot_n, "bad": tpot_bad,
                         "threshold_s": STATE_SLO_TPOT_S},
            },
        }
        if thermal is not None:
            # Absent on non-paged engines; the fleet scrape parser
            # tolerates the missing key.
            out["kv_thermal"] = thermal
        return out


class ServeMetricsExporter(ExporterBase):
    """Serves a RequestRecorder's registry on /metrics. The recorder is
    push-updated by the engines, so poll_once only runs the optional
    poll_fn (e.g. a gauge refresh for an idle engine)."""

    name = "serve-metrics"

    def __init__(self, recorder: RequestRecorder, port: int = 0,
                 host: str = "", interval: float = 5.0, poll_fn=None,
                 hbm_poller="auto"):
        self.recorder = recorder
        self.registry = recorder.registry
        self.port = port
        self.host = host
        self.interval = interval
        self._poll_fn = poll_fn
        if hbm_poller == "auto":
            # Serving metrics ports carry live per-device memory
            # telemetry (metrics/introspection.py), for the card this
            # exporter is built on. A shared registry that already holds
            # the gauges keeps its existing poller.
            from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
                HbmPoller,
            )
            try:
                hbm_poller = HbmPoller(registry=self.registry)
            except ValueError:
                hbm_poller = None
        self.hbm_poller = hbm_poller
        self._stop = threading.Event()

    def poll_once(self) -> None:
        if self._poll_fn is not None:
            self._poll_fn()
        if self.hbm_poller is not None:
            self.hbm_poller.poll_once()
