"""Per-request tracing on top of the EventBus.

`RequestRecorder` answers "what is the p99?"; this module answers
"where did THIS request's p99 go?". Every admitted request gets a
trace keyed by its request id, and traced requests emit async span
events (`eid=rid`, cat "req") for each lifecycle stage:

    req/queue          b/e   enqueue -> admit (re-opened on preempt,
                             so the requeue wait is a second slice)
    req/prefill        b/e   admit -> first token
    req/prefill_chunk  b/e   one chunked-prefill step (engine tick or
                             prefill pool worker)
    req/prefix_lookup  b/e   paged admission prefix-cache probe
    req/page_alloc     b/e   paged admission / growth page allocation
    req/page_stall     b/e   admission blocked on free pages -> admit
    req/dispatch       n     one decode-tick dispatch covering the rid
    req/fetch          b/e   deferred device fetch of the rid's tick
    req/stream         b/e   SSE fan-out of the rid's tokens
    req/preempt        n     preemption (victim track)
    req/supervisor_restart  n  the supervisor failed the rid while it
                             recovered a dead engine worker
    req/pool_restart   n     a prefill-pool worker died while the rid
                             was mid-prefill (it resumes; nothing fails)

Sampling has two layers, matching the Dapper lineage:

  - HEAD sampling: `--trace-sample-rate R` picks requests at admission
    time, deterministically from the request id (Knuth multiplicative
    hash for an int, crc32 of its text otherwise), so the decision is
    reproducible across runs, equal to the JAX package's, and a client
    (cli/loadgen) sampling its own side of the same request agrees
    with itself. Clients may also force a request into the sample with
    the `trace` field of the POST body (threaded through as
    `start(..., force=True)`).
  - TAIL sampling: non-sampled requests buffer their spans in a small
    bounded per-request buffer (first-half + last-half, so neither the
    admission story nor the failure story is lost to truncation).
    When the request FAILS, was PREEMPTED or violates its SLO, the
    buffer is flushed into the bus with the ORIGINAL timestamps — the
    interesting requests are
    always traced, at the cost of one bounded buffer per in-flight
    request. Clean, in-SLO requests discard their buffer at finish.

The tracer is a thin layer: emission goes through the process-wide
EventBus ring, so dumps, JSONL streaming, /debugz, taps and the
cross-process merge (`events.merge_traces`, `trace merge`) all see
the same spans with no extra plumbing. When the bus is
disabled `start()` returns None and every call site degrades to one
dict lookup returning None — the untraced hot path stays allocation-
free, same cost discipline as metrics/events.py.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib

from container_engine_accelerators_tpu_torch.metrics import events

CAT = "req"

SPAN_QUEUE = "req/queue"
SPAN_PREFILL = "req/prefill"
SPAN_PREFILL_CHUNK = "req/prefill_chunk"
SPAN_PREFIX_LOOKUP = "req/prefix_lookup"
SPAN_PAGE_ALLOC = "req/page_alloc"
SPAN_PAGE_STALL = "req/page_stall"
SPAN_FETCH = "req/fetch"
SPAN_STREAM = "req/stream"
EV_DISPATCH = "req/dispatch"
EV_PREEMPT = "req/preempt"
EV_SUPERVISOR_RESTART = "req/supervisor_restart"
EV_POOL_RESTART = "req/pool_restart"
EV_TRUNCATED = "req/trace_truncated"

DEFAULT_SAMPLE_RATE = 0.01
DEFAULT_TAIL_EVENTS = 128
DEFAULT_TAIL_REQUESTS = 512

_KNUTH = 2654435761  # golden-ratio multiplicative hash constant


def head_sampled(rid, rate: float) -> bool:
    """Deterministic head-sampling decision for a request id. Pure
    function of (rid, rate) so server and client agree on their own
    ids and tests can pick ids on either side of the cut."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    if isinstance(rid, int):
        h = (rid * _KNUTH) & 0xFFFFFFFF
    else:
        h = zlib.crc32(str(rid).encode())
    return h / 4294967296.0 < rate


class SpanHandle:
    """Per-request emission handle. `sampled` handles write straight
    to the bus; tail handles buffer (bounded, both ends kept) until
    `RequestTracer.finish()` decides to flush or discard."""

    __slots__ = ("rid", "sampled", "tags", "promoted", "promote_reason",
                 "slo_violated", "_head", "_tail", "_head_cap",
                 "_buffered", "_lock")

    def __init__(self, rid, sampled: bool, tags=None,
                 tail_events: int = DEFAULT_TAIL_EVENTS):
        self.rid = rid
        self.sampled = sampled
        self.tags = dict(tags) if tags else None
        self.promoted = False
        self.promote_reason = None
        self.slo_violated = False
        self._head_cap = tail_events // 2
        self._head: list = []
        self._tail: collections.deque = collections.deque(
            maxlen=max(1, tail_events - self._head_cap))
        self._buffered = 0
        self._lock = threading.Lock()

    # ---------- emission ----------

    def _ev(self, ph, name, args, ts):
        if self.tags:
            args = {**self.tags, **args} if args else dict(self.tags)
        if self.sampled:
            events.get_bus()._emit(ph, name, CAT, args, ts=ts,
                                   eid=self.rid)
            return
        if ts is None:
            ts = time.monotonic()
        with self._lock:
            self._buffered += 1
            if len(self._head) < self._head_cap:
                self._head.append((ph, ts, name, args))
            else:
                self._tail.append((ph, ts, name, args))

    def begin(self, name, args=None, ts=None):
        self._ev("b", name, args, ts)

    def end(self, name, args=None, ts=None):
        self._ev("e", name, args, ts)

    def instant(self, name, args=None, ts=None):
        self._ev("n", name, args, ts)

    def span(self, name, args=None):
        return _HandleSpan(self, name, args)

    # ---------- tail-sampling state ----------

    def promote(self, reason: str) -> None:
        """Mark this request as interesting: its buffer is flushed at
        finish even if the outcome is ok (a preemption, a forced
        trace)."""
        if not self.promoted:
            self.promoted = True
            self.promote_reason = reason

    def note_ttft(self, ttft_ms: float, slo_ms=None) -> None:
        if slo_ms is not None and ttft_ms > slo_ms:
            self.slo_violated = True

    def note_tpot(self, tpot_ms: float, slo_ms=None) -> None:
        if slo_ms is not None and tpot_ms > slo_ms:
            self.slo_violated = True

    def _flush(self) -> int:
        """Write the buffered spans into the bus with their original
        timestamps; a `req/trace_truncated` instant records how many
        events the bounded buffer lost."""
        bus = events.get_bus()
        with self._lock:
            evs = self._head + list(self._tail)
            dropped = self._buffered - len(evs)
            self._head = []
            self._tail.clear()
            self._buffered = 0
        for ph, ts, name, args in evs:
            bus._emit(ph, name, CAT, args, ts=ts, eid=self.rid)
        if dropped > 0:
            bus._emit("n", EV_TRUNCATED, CAT, {"dropped": dropped},
                      eid=self.rid)
        return len(evs)


class _HandleSpan:
    """b/e pair around a with-block on one request's async track."""

    __slots__ = ("_h", "_name", "_args")

    def __init__(self, h, name, args):
        self._h = h
        self._name = name
        self._args = args

    def __enter__(self):
        self._h.begin(self._name, self._args)
        return self

    def __exit__(self, *exc):
        self._h.end(self._name)
        return False


class RequestTracer:
    """Owns the rid -> SpanHandle table and the sampling policy."""

    def __init__(self, sample_rate: float = DEFAULT_SAMPLE_RATE,
                 slo_ttft_ms=None, slo_tpot_ms=None,
                 tail_events: int = DEFAULT_TAIL_EVENTS,
                 max_tail_requests: int = DEFAULT_TAIL_REQUESTS,
                 base_tags=None):
        self.sample_rate = sample_rate
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_tpot_ms = slo_tpot_ms
        self.tail_events = tail_events
        self.max_tail_requests = max_tail_requests
        # Process-level tags stamped into every span of every traced
        # request; per-request tags override on key collision.
        self.base_tags = dict(base_tags) if base_tags else None
        self._handles: dict = {}
        self._lock = threading.Lock()
        self.started = 0
        self.sampled_n = 0
        self.flushed = 0
        self.discarded = 0

    def start(self, rid, force: bool = False, tags=None):
        """Create (or return the existing) handle for `rid`. Returns
        None when the bus is disabled — tracing rides the flight
        recorder; no recorder, no spans."""
        if not events.enabled():
            return None
        if self.base_tags:
            tags = {**self.base_tags, **tags} if tags \
                else dict(self.base_tags)
        with self._lock:
            h = self._handles.get(rid)
            if h is not None:
                if force and not h.sampled:
                    h.promote("forced")
                if tags and not h.tags:
                    h.tags = dict(tags)
                return h
            sampled = force or head_sampled(rid, self.sample_rate)
            tail_events = self.tail_events
            if not sampled and len(self._handles) >= self.max_tail_requests:
                tail_events = 2  # degraded: counted, mostly dropped
            h = SpanHandle(rid, sampled, tags=tags,
                           tail_events=tail_events)
            self._handles[rid] = h
            self.started += 1
            if sampled:
                self.sampled_n += 1
            return h

    def handle(self, rid):
        """Lock-free fast path for hot call sites; None when untracked."""
        return self._handles.get(rid)

    def finish(self, rid, outcome: str = "ok"):
        """Close the trace: tail handles flush on error/preempt/SLO-
        violation/promotion, discard otherwise."""
        with self._lock:
            h = self._handles.pop(rid, None)
        if h is None:
            return None
        if not h.sampled:
            if outcome != "ok" or h.promoted or h.slo_violated:
                why = ("outcome" if outcome != "ok" else
                       h.promote_reason or "slo")
                h.instant("req/tail_sampled", {"why": why})
                h.sampled = True  # later touches go straight to the bus
                self.flushed += 1
                h._flush()
            else:
                self.discarded += 1
        return h

    def stats(self) -> dict:
        with self._lock:
            return {"in_flight": len(self._handles),
                    "started": self.started, "sampled": self.sampled_n,
                    "flushed": self.flushed, "discarded": self.discarded,
                    "sample_rate": self.sample_rate}


# ---------- process-wide tracer + fast-path helpers ----------

_TRACER: RequestTracer | None = None


def configure(sample_rate: float = DEFAULT_SAMPLE_RATE, slo_ttft_ms=None,
              slo_tpot_ms=None, tail_events: int = DEFAULT_TAIL_EVENTS,
              max_tail_requests: int = DEFAULT_TAIL_REQUESTS,
              base_tags=None) -> RequestTracer:
    global _TRACER
    _TRACER = RequestTracer(sample_rate=sample_rate,
                            slo_ttft_ms=slo_ttft_ms,
                            slo_tpot_ms=slo_tpot_ms,
                            tail_events=tail_events,
                            max_tail_requests=max_tail_requests,
                            base_tags=base_tags)
    return _TRACER


def get() -> RequestTracer | None:
    return _TRACER


def start(rid, force: bool = False, tags=None):
    t = _TRACER
    if t is None:
        return None
    return t.start(rid, force=force, tags=tags)


def handle(rid):
    """The per-tick fast path: one global load + one dict get."""
    t = _TRACER
    if t is None:
        return None
    return t._handles.get(rid)


def finish(rid, outcome: str = "ok"):
    t = _TRACER
    if t is None:
        return None
    return t.finish(rid, outcome)


def _reset_for_tests() -> None:
    global _TRACER
    _TRACER = None
