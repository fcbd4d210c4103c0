"""Flight recorder: a process-wide, bounded, thread-safe event bus with
Chrome-trace (Perfetto) export, the one timeline that the serving
engines' request recorder, the request tracer and the health checker
all write to. The same event names, categories and dump format as the
JAX package's, so a dump of either merges with the other.

    span begin/end      B/E   per-thread nested phases
    complete            X     retroactive phases with a known duration
    instant             i     point events (health errors, preemptions,
                              KV thrash)
    counter             C     gauge samples (queue depth, slots, KV
                              pages, thermal buckets)
    async begin/inst/end b/n/e cross-thread request lifecycles keyed by
                              request id

Each event carries a monotonic timestamp, pid/tid, category and an
optional args dict; the bus records ONE (unix_time, monotonic) anchor
pair per process so dumps from different processes merge onto a single
epoch-aligned timeline (`merge_traces`, `cli/trace.py`).

Cost: the bus is disabled by default and every emit helper checks one
attribute before doing anything else, so the disabled path allocates
nothing. Producers that would build an args dict guard on
`events.enabled()` first. Enabled emission is a tuple build and a store
into the ring under a lock.

The ring is bounded (default 65536 events) and overwrites the oldest,
so after a crash it holds the last N events. Overwrites are counted
(`dropped`) and served on /debugz and as
`tpu_trace_events_dropped_total` on every exporter port
(metrics/serving.py), so a reader can tell "nothing happened" from "the
evidence was overwritten".

Live consumers that must not lose events to wraparound subscribe a
bounded tap (`subscribe()` -> EventTap): every enabled emit is also
appended to each tap's own deque under the same lock, the tap counts
its own overflow, and `drain()` hands the backlog over. The JSONL
streamer (`stream_jsonl`) is one.

Dumps are written on demand (`dump_now`), on SIGUSR2 (main thread
only: `enable(signals=True)`), and from atexit / sys.excepthook when a
dump path is configured (`enable(dump_path=...)` or the
TPU_TRACE_DUMP env var; a directory gets a per-pid `trace-<pid>.json`).
A dump opens in ui.perfetto.dev or chrome://tracing;
`otherData.anchor` carries the epoch anchor that `trace merge` uses to
align processes.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import logging
import os
import signal
import socket
import sys
import threading
import time

log = logging.getLogger(__name__)

TRACE_DUMP_ENV = "TPU_TRACE_DUMP"
DEFAULT_CAPACITY = 65536

# Synthetic pid base for merged non-bus sources (SSE logs):
# far above real Linux pids (max 4194304) so tracks never collide.
_SYNTH_PID_BASE = 9_000_000


def _now_anchor(process_name: str) -> dict:
    """One (unix, monotonic) clock pair, captured as close together as
    possible — the merge error between two processes is bounded by the
    capture skew of their anchors."""
    t = time.time()
    m = time.monotonic()
    return {"unix_time": t, "monotonic": m, "pid": os.getpid(),
            "host": socket.gethostname(), "process_name": process_name}


class _Span:
    """B/E span context: B at entry so an in-progress phase is visible
    in a crash dump even though its E never lands."""

    __slots__ = ("_bus", "_name", "_cat", "_args")

    def __init__(self, bus, name, cat, args):
        self._bus = bus
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._bus._emit("B", self._name, self._cat, self._args)
        return self

    def __exit__(self, *exc):
        self._bus._emit("E", self._name, self._cat, None)
        return False


class EventTap:
    """Bounded subscription onto an EventBus: every enabled emit is
    appended here too (raw event tuples, oldest first). The deque is
    bounded and the tap counts its own overflow, so a slow consumer
    degrades to *known* data loss, never to unbounded memory — and the
    consumer can report the gap instead of trusting a silent hole."""

    __slots__ = ("name", "capacity", "_dq", "received", "dropped")

    def __init__(self, name: str = "tap", capacity: int = 16384):
        self.name = name
        self.capacity = capacity
        self._dq: collections.deque = collections.deque(maxlen=capacity)
        self.received = 0
        self.dropped = 0

    def _push(self, ev) -> None:
        # Called under the bus lock.
        if len(self._dq) == self.capacity:
            self.dropped += 1
        self._dq.append(ev)
        self.received += 1

    def drain(self) -> list:
        """All queued event tuples, oldest first; clears the backlog."""
        out = []
        while True:
            try:
                out.append(self._dq.popleft())
            except IndexError:
                return out


class EventBus:
    """Bounded ring of trace events; see the module docstring for the
    event taxonomy and cost discipline."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = False, process_name: str | None = None):
        self.capacity = capacity
        self.enabled = enabled
        self.process_name = process_name or os.path.basename(
            sys.argv[0] or "python")
        self._buf: list = [None] * capacity
        self._n = 0  # total emitted; ring slot = _n % capacity
        self._lock = threading.Lock()
        self._threads: dict[int, str] = {}
        self._taps: list[EventTap] = []
        # Fleet replica identity: stamped into the anchor (so dumps and
        # JSONL headers carry it into merge_traces) and the process
        # track name. None outside a fleet.
        self.replica: str | None = None
        self.anchor = _now_anchor(self.process_name)

    # ---------- emission (hot path) ----------

    def _emit(self, ph, name, cat, args, ts=None, dur=None, eid=None):
        if not self.enabled:
            return
        if ts is None:
            ts = time.monotonic()
        tid = threading.get_ident()
        with self._lock:
            ev = (ph, ts, tid, name, cat, dur, eid, args)
            self._buf[self._n % self.capacity] = ev
            self._n += 1
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
            for tap in self._taps:
                tap._push(ev)

    def begin(self, name, cat="", args=None):
        self._emit("B", name, cat, args)

    def end(self, name, cat=""):
        self._emit("E", name, cat, None)

    def span(self, name, cat="", args=None):
        """Context manager emitting B/E; a shared no-op context when
        disabled (no per-call allocation on the disabled path)."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, cat, args)

    def instant(self, name, cat="", args=None, ts=None):
        self._emit("i", name, cat, args, ts=ts)

    def complete(self, name, start_ts, dur, cat="", args=None):
        """Retroactive phase: [start_ts, start_ts + dur] in monotonic
        seconds (ph X) — for producers that time a phase themselves."""
        self._emit("X", name, cat, args, ts=start_ts, dur=dur)

    def counter(self, name, values, cat="", ts=None):
        """One sample on a counter track; `values` is {series: number}."""
        self._emit("C", name, cat, values, ts=ts)

    def async_begin(self, name, eid, cat="", args=None, ts=None):
        self._emit("b", name, cat, args, ts=ts, eid=eid)

    def async_instant(self, name, eid, cat="", args=None, ts=None):
        self._emit("n", name, cat, args, ts=ts, eid=eid)

    def async_end(self, name, eid, cat="", args=None, ts=None):
        self._emit("e", name, cat, args, ts=ts, eid=eid)

    # ---------- subscriptions ----------

    def subscribe(self, name: str = "tap",
                  capacity: int = 16384) -> EventTap:
        """Attach a bounded tap fed by every subsequent enabled emit;
        the caller owns draining it (and unsubscribing when done)."""
        tap = EventTap(name, capacity)
        with self._lock:
            self._taps.append(tap)
        return tap

    def unsubscribe(self, tap: EventTap) -> None:
        with self._lock:
            try:
                self._taps.remove(tap)
            except ValueError:
                log.debug("unsubscribe of unknown tap %r", tap.name)

    # ---------- inspection / export ----------

    @property
    def emitted(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    @property
    def tap_dropped(self) -> int:
        """Events lost to slow tap consumers, summed over live taps:
        the JSONL streamer's blind spots, served on /metrics next to the
        ring's own `dropped`, so a truncated trace is labeled."""
        with self._lock:
            return sum(t.dropped for t in self._taps)

    def snapshot(self) -> list:
        """Raw event tuples, oldest first (at most `capacity`)."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return list(self._buf[:n])
            k = n % self.capacity
            return self._buf[k:] + self._buf[:k]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0
            self._threads.clear()

    def _event_dict(self, ev) -> dict:
        ph, ts, tid, name, cat, dur, eid, args = ev
        d = {"name": name, "cat": cat or "default", "ph": ph,
             "ts": round(ts * 1e6, 3), "pid": self.anchor["pid"],
             "tid": tid}
        if dur is not None:
            d["dur"] = round(dur * 1e6, 3)
        if eid is not None:
            d["id"] = str(eid)
        if ph == "i":
            d["s"] = "t"  # thread-scoped instant
        if args:
            d["args"] = dict(args)
        return d

    def _meta_events(self) -> list[dict]:
        pid = self.anchor["pid"]
        # Replica-stamped track name: N replicas' dumps merge into
        # per-replica track groups instead of anonymous pid tracks.
        name = (f"{self.process_name}[{self.replica}]" if self.replica
                else self.process_name)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": f"{name} "
                                  f"({self.anchor['host']} pid {pid})"}}]
        with self._lock:
            threads = dict(self._threads)
        for tid, tname in sorted(threads.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        return meta

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (dict). Timestamps are MONOTONIC µs;
        `otherData.anchor` holds the epoch pair merge needs to rebase."""
        evs = [self._event_dict(ev) for ev in self.snapshot()]
        evs.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": self._meta_events() + evs,
            "displayTimeUnit": "ms",
            "otherData": {"anchor": dict(self.anchor),
                          "emitted": self._n, "dropped": self.dropped},
        }

    def dump(self, path: str) -> str:
        """Write the ring as Chrome-trace JSON, atomically (tmp +
        os.replace) so a reader racing a SIGUSR2 dump never sees a torn
        file. Returns the final path."""
        path = _resolve_dump_path(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f)
        os.replace(tmp, path)
        return path

    def debugz(self, limit: int = 256) -> dict:
        """Last-N-events JSON payload for the /debugz endpoint."""
        evs = [self._event_dict(ev) for ev in self.snapshot()[-limit:]]
        with self._lock:
            taps = [{"name": t.name, "capacity": t.capacity,
                     "received": t.received, "dropped": t.dropped}
                    for t in self._taps]
        return {"enabled": self.enabled, "capacity": self.capacity,
                "emitted": self._n, "dropped": self.dropped,
                "taps": taps, "anchor": dict(self.anchor), "events": evs}


# ---------- process-wide bus + module-level fast-path helpers ----------

_NULL_CTX = contextlib.nullcontext()
_BUS = EventBus()
_DUMP_PATH: str | None = None
_HOOKS_INSTALLED = False
_SIGNAL_INSTALLED = False


def get_bus() -> EventBus:
    return _BUS


def enabled() -> bool:
    """Producers building an args dict guard on this first, so the
    disabled hot path allocates nothing."""
    return _BUS.enabled


def instant(name, cat="", args=None):
    if _BUS.enabled:
        _BUS._emit("i", name, cat, args)


def counter(name, values, cat=""):
    if _BUS.enabled:
        _BUS._emit("C", name, cat, values)


def complete(name, start_ts, dur, cat="", args=None):
    if _BUS.enabled:
        _BUS._emit("X", name, cat, args, ts=start_ts, dur=dur)


def span(name, cat="", args=None):
    return _BUS.span(name, cat, args)


def async_begin(name, eid, cat="", args=None):
    if _BUS.enabled:
        _BUS._emit("b", name, cat, args, eid=eid)


def async_instant(name, eid, cat="", args=None):
    if _BUS.enabled:
        _BUS._emit("n", name, cat, args, eid=eid)


def async_end(name, eid, cat="", args=None):
    if _BUS.enabled:
        _BUS._emit("e", name, cat, args, eid=eid)


def _resolve_dump_path(path: str) -> str:
    """A directory (existing, or spelled with a trailing separator)
    gets a per-pid file so multi-process jobs sharing TPU_TRACE_DUMP
    never clobber each other."""
    if path.endswith(os.sep) or os.path.isdir(path):
        return os.path.join(path, f"trace-{os.getpid()}.json")
    return path


def enable(capacity: int | None = None, dump_path: str | None = None,
           signals: bool = False, process_name: str | None = None
           ) -> EventBus:
    """Turn the process-wide bus on (idempotent; later calls update the
    dump path / name). `dump_path` arms the flight recorder: atexit and
    uncaught-exception dumps, plus a SIGUSR2 on-demand dump when
    `signals` is set (main thread only; silently skipped elsewhere)."""
    global _DUMP_PATH
    bus = _BUS
    if capacity and capacity != bus.capacity:
        with bus._lock:
            bus.capacity = capacity
            bus._buf = [None] * capacity
            bus._n = 0
    if process_name:
        bus.process_name = process_name
    # Re-anchor at enable time: the pairing should reflect the clocks
    # when recording starts, not module import. The replica stamp
    # survives the re-anchor (set_replica_id may run first).
    bus.anchor = _now_anchor(bus.process_name)
    if bus.replica:
        bus.anchor["replica"] = bus.replica
    bus.enabled = True
    if dump_path:
        _DUMP_PATH = dump_path
        _install_exit_hooks()
        if signals:
            _install_signal_hook()
    return bus


def set_replica_id(rid) -> None:
    """Stamp this process's fleet replica id onto the bus: the anchor
    (and so every dump, JSONL header and merge source) and the Perfetto
    process track name carry it. Survives a later enable() re-anchor;
    idempotent. cli/serve.py calls this right after arming the bus."""
    bus = _BUS
    bus.replica = str(rid) if rid is not None else None
    if bus.replica:
        bus.anchor["replica"] = bus.replica
    else:
        bus.anchor.pop("replica", None)


def disable(clear: bool = False) -> None:
    _BUS.enabled = False
    if clear:
        _BUS.clear()


def configure_from_env(process_name: str | None = None) -> bool:
    """Honor TPU_TRACE_DUMP: when set, enable the bus with that dump
    path and arm atexit/SIGUSR2 dumps. Returns True when enabled."""
    path = os.environ.get(TRACE_DUMP_ENV)
    if not path:
        return False
    enable(dump_path=path, signals=True, process_name=process_name)
    return True


def dump_now(path: str | None = None) -> str | None:
    """Dump the ring to `path` (or the configured dump path). Never
    raises — the flight recorder must not take down its host."""
    path = path or _DUMP_PATH
    if not path:
        return None
    try:
        out = _BUS.dump(path)
        log.info("event-bus trace dumped to %s (%d events, %d dropped)",
                 out, min(_BUS.emitted, _BUS.capacity), _BUS.dropped)
        return out
    except Exception:
        log.exception("event-bus dump to %s failed", path)
        return None


def _install_exit_hooks() -> None:
    global _HOOKS_INSTALLED
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True
    atexit.register(_atexit_dump)
    prev_hook = sys.excepthook

    def _crash_dump(exc_type, exc, tb):
        if _BUS.enabled:
            instant("crash", "flight",
                    {"type": getattr(exc_type, "__name__", str(exc_type)),
                     "message": str(exc)[:300]})
            dump_now()
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _crash_dump


def _atexit_dump() -> None:
    if _BUS.enabled and _DUMP_PATH:
        dump_now()


def _install_signal_hook() -> None:
    global _SIGNAL_INSTALLED
    if _SIGNAL_INSTALLED:
        return

    def _on_sigusr2(signum, frame):
        instant("sigusr2_dump", "flight")
        dump_now()

    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
        _SIGNAL_INSTALLED = True
    except (ValueError, AttributeError, OSError) as e:
        # Non-main thread (ValueError) or a platform without SIGUSR2 —
        # on-demand dumps still work via dump_now()/atexit.
        log.warning("SIGUSR2 trace-dump handler not installed: %s", e)


def _reset_for_tests() -> None:
    """Restore pristine module state (tests only)."""
    global _DUMP_PATH, _JSONL_WRITER
    if _JSONL_WRITER is not None:
        _JSONL_WRITER.close()
        _JSONL_WRITER = None
    _BUS.enabled = False
    _BUS.clear()
    with _BUS._lock:
        _BUS._taps.clear()
    _BUS.replica = None
    _BUS.anchor.pop("replica", None)
    _DUMP_PATH = None


# ---------- per-process JSONL streaming ----------

def _resolve_jsonl_path(path: str) -> str:
    """Directory paths get a per-pid `events-<pid>.jsonl` so every
    process in a job can share one --trace-jsonl directory without
    clobbering (same contract as _resolve_dump_path)."""
    if path.endswith(os.sep) or os.path.isdir(path):
        return os.path.join(path, f"events-{os.getpid()}.jsonl")
    return path


class JsonlWriter:
    """Streams the bus to an append-only JSONL file via a bounded tap
    and a daemon flusher thread, so long runs survive the ring's
    wraparound: the ring keeps the last N events for crash dumps, the
    JSONL keeps the WHOLE run for offline merge (`trace merge`).

    Line 1 is a header record carrying the process anchor; each event
    line is the same Chrome event dict `dump()` writes (monotonic µs
    timestamps — the merge rebases via the header anchor). When the
    tap overflows, a `{"kind": "drops"}` record lands in-stream so the
    reader can label the gap instead of missing it silently."""

    def __init__(self, bus: EventBus, path: str,
                 flush_interval: float = 0.25,
                 tap_capacity: int = 32768):
        self.path = _resolve_jsonl_path(path)
        self.bus = bus
        self.flush_interval = flush_interval
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "w")
        self._write_rec({"kind": "anchor", "anchor": dict(bus.anchor),
                         "process_name": bus.process_name,
                         "capacity": bus.capacity})
        self._reported_dropped = 0
        self._stop = threading.Event()
        self._closed = False
        self._tap = bus.subscribe(
            f"jsonl:{os.path.basename(self.path)}", tap_capacity)
        self._thread = threading.Thread(
            target=self._run, name="trace-jsonl-flusher", daemon=True)
        self._thread.start()

    def _write_rec(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")

    def _drain_once(self) -> int:
        evs = self._tap.drain()
        for ev in evs:
            self._write_rec(self.bus._event_dict(ev))
        if self._tap.dropped > self._reported_dropped:
            self._write_rec({"kind": "drops",
                             "tap_dropped": self._tap.dropped})
            self._reported_dropped = self._tap.dropped
        if evs:
            self._f.flush()
        return len(evs)

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                self._drain_once()
            except Exception:
                log.exception("trace-jsonl flush to %s failed", self.path)
                return

    def close(self) -> None:
        """Stop the flusher, drain the backlog, close the file. Never
        raises — the flight recorder must not take down its host."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.bus.unsubscribe(self._tap)
        try:
            self._drain_once()
            self._f.close()
        except Exception:
            log.exception("trace-jsonl close of %s failed", self.path)


_JSONL_WRITER: JsonlWriter | None = None


def stream_jsonl(path: str, flush_interval: float = 0.25) -> JsonlWriter:
    """Attach (or re-target) the process-wide JSONL streamer; enables
    the bus if it isn't already on. Closed at exit so the tail of the
    stream lands on disk."""
    global _JSONL_WRITER
    if not _BUS.enabled:
        enable()
    if _JSONL_WRITER is not None:
        if _JSONL_WRITER.path == _resolve_jsonl_path(path):
            return _JSONL_WRITER
        _JSONL_WRITER.close()
    _JSONL_WRITER = JsonlWriter(_BUS, path, flush_interval=flush_interval)
    atexit.register(_atexit_close_jsonl)
    return _JSONL_WRITER


def _atexit_close_jsonl() -> None:
    if _JSONL_WRITER is not None:
        _JSONL_WRITER.close()


# ---------- cross-process merge ----------

def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _synth_meta(pid: int, name: str) -> dict:
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _train_jsonl_events(path: str, pid: int) -> list[dict]:
    """The train recorder's crash-safe JSONL step log as X/instant
    events. Records carry `t` = unix-epoch seconds at record time (phase
    END), so phases rebase without the writer's monotonic anchor."""
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        read_metrics_jsonl,
    )

    out = []

    def x(name, end_s, dur_s, args):
        dur_s = max(dur_s, 0.0)
        out.append({"name": name, "cat": "train", "ph": "X",
                    "ts": round((end_s - dur_s) * 1e6, 3),
                    "dur": round(dur_s * 1e6, 3), "pid": pid, "tid": 1,
                    "args": args})

    for rec in read_metrics_jsonl(path):
        kind = rec.get("kind")
        t = rec.get("t")
        if t is None:
            continue
        if kind == "step":
            compute = float(rec.get("compute_s", 0.0))
            dw = float(rec.get("data_wait_s", 0.0))
            args = {k: rec[k] for k in ("step", "tokens", "loss",
                                        "mfu_inst", "first") if k in rec}
            x("train/step", t, compute, args)
            if dw > 0:
                x("train/data_wait", t - compute, dw,
                  {"step": rec.get("step")})
        elif kind == "window":
            x("train/window", t, float(rec.get("total_s", 0.0)),
              {"n": rec.get("n"), "tokens": rec.get("tokens")})
        elif kind == "ckpt_save":
            x("train/ckpt_save", t, float(rec.get("seconds", 0.0)), {})
        elif kind == "recompile":
            x("train/recompile", t, float(rec.get("seconds", 0.0)),
              {"fn": rec.get("fn")})
        elif kind == "restore":
            x("train/restore", t, float(rec.get("seconds", 0.0)),
              {"step": rec.get("step")})
        elif kind == "fast_forward":
            x("train/fast_forward", t, float(rec.get("seconds", 0.0)),
              {"batches": rec.get("batches")})
        else:
            out.append({"name": f"train/{kind}", "cat": "train",
                        "ph": "i", "s": "t", "ts": round(t * 1e6, 3),
                        "pid": pid, "tid": 1})
    return out


def _sse_log_events(path: str, pid: int) -> list[dict]:
    """Stamped SSE event-log lines ({"token"/"done"/"error", "ts", "t",
    "req"}) as instant events. Lines without the epoch stamp `t` (logs
    from before it was added) are skipped — monotonic-only stamps from
    an unknown process cannot be aligned."""
    out = []
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if line.startswith("data:"):
            line = line[len("data:"):].strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            continue
        t = ev.get("t")
        if t is None:
            continue
        if "token" in ev:
            name = "sse/token"
        elif ev.get("done"):
            name = "sse/done"
        elif "error" in ev:
            name = "sse/error"
        else:
            name = "sse/event"
        args = {k: ev[k] for k in ("req", "token", "error") if k in ev}
        out.append({"name": name, "cat": "sse", "ph": "i", "s": "t",
                    "ts": round(float(t) * 1e6, 3), "pid": pid, "tid": 1,
                    "args": args})
    return out


def _event_jsonl_records(path: str):
    """Parsed records of a JsonlWriter stream, tolerating a torn final
    line (the writer may have been killed mid-append)."""
    try:
        with open(path, errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return []
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return out


def merge_traces(dump_paths=(), train_jsonl_paths=(), sse_log_paths=(),
                 event_jsonl_paths=()) -> dict:
    """Merge per-process EventBus dumps, the train recorder's JSONL step
    logs, stamped SSE event logs and streamed EventBus JSONL files into
    ONE clock-aligned Chrome trace.

    Every source is rebased to unix-epoch µs (bus dumps and JSONL
    streams by their recorded anchor, step logs and SSE logs by their
    per-record epoch stamps), then shifted so the earliest event sits at
    ts 0; `otherData.epoch_origin_us` records the subtracted origin.
    Per-source drop counts ride along in `otherData.sources`, so a
    truncated merge is labeled."""
    merged: list[dict] = []
    meta: list[dict] = []
    sources = []
    synth_pid = _SYNTH_PID_BASE

    for path in dump_paths:
        data = _load_json(path)
        other = data.get("otherData") or {}
        anchor = other.get("anchor") or {}
        off_us = (float(anchor.get("unix_time", 0.0))
                  - float(anchor.get("monotonic", 0.0))) * 1e6
        n = 0
        for ev in data.get("traceEvents", []):
            ev = dict(ev)
            if ev.get("ph") == "M":
                meta.append(ev)
                continue
            ev["ts"] = float(ev.get("ts", 0.0)) + off_us
            merged.append(ev)
            n += 1
        sources.append({"path": path, "kind": "eventbus", "events": n,
                        "pid": anchor.get("pid"),
                        "replica": anchor.get("replica"),
                        "dropped": other.get("dropped", 0)})

    for path in event_jsonl_paths:
        recs = _event_jsonl_records(path)
        anchor = {}
        pname = None
        dropped = 0
        n = 0
        evs: list[dict] = []
        for rec in recs:
            kind = rec.get("kind")
            if kind == "anchor":
                anchor = rec.get("anchor") or {}
                pname = rec.get("process_name")
                continue
            if kind == "drops":
                dropped = max(dropped, int(rec.get("tap_dropped", 0)))
                continue
            if "ph" not in rec or "ts" not in rec:
                continue
            evs.append(rec)
        if not anchor:
            # Monotonic-only stamps from an unknown process cannot be
            # aligned; record the skip instead of merging garbage.
            sources.append({"path": path, "kind": "event-jsonl",
                            "events": 0, "dropped": dropped,
                            "skipped": "no_anchor"})
            continue
        off_us = (float(anchor.get("unix_time", 0.0))
                  - float(anchor.get("monotonic", 0.0))) * 1e6
        pid = anchor.get("pid")
        for ev in evs:
            ev = dict(ev)
            if ev.get("ph") == "M":
                meta.append(ev)
                continue
            ev["ts"] = float(ev.get("ts", 0.0)) + off_us
            merged.append(ev)
            n += 1
        if pid is not None and pname:
            label = (f"{pname}[{anchor['replica']}]"
                     if anchor.get("replica") else pname)
            meta.append(_synth_meta(
                int(pid), f"{label} ({anchor.get('host', '?')} "
                          f"pid {pid})"))
        sources.append({"path": path, "kind": "event-jsonl",
                        "events": n, "pid": pid, "dropped": dropped,
                        "replica": anchor.get("replica"),
                        "process_name": pname})

    for path in train_jsonl_paths:
        synth_pid += 1
        evs = _train_jsonl_events(path, synth_pid)
        meta.append(_synth_meta(
            synth_pid, f"train-jsonl:{os.path.basename(path)}"))
        merged.extend(evs)
        sources.append({"path": path, "kind": "train-jsonl",
                        "events": len(evs), "pid": synth_pid})

    for path in sse_log_paths:
        synth_pid += 1
        evs = _sse_log_events(path, synth_pid)
        meta.append(_synth_meta(
            synth_pid, f"sse-log:{os.path.basename(path)}"))
        merged.extend(evs)
        sources.append({"path": path, "kind": "sse-log",
                        "events": len(evs), "pid": synth_pid})

    origin = min((e["ts"] for e in merged), default=0.0)
    for ev in merged:
        ev["ts"] = round(ev["ts"] - origin, 3)
    merged.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + merged,
        "displayTimeUnit": "ms",
        "otherData": {"epoch_origin_us": round(origin, 3),
                      "sources": sources},
    }


def write_merged(out_path: str, dump_paths=(), train_jsonl_paths=(),
                 sse_log_paths=(), event_jsonl_paths=()) -> dict:
    trace = merge_traces(dump_paths, train_jsonl_paths, sse_log_paths,
                         event_jsonl_paths)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    # Same atomic idiom as dump(): a viewer re-reading the merged
    # timeline must never race a re-merge into a torn file.
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, out_path)
    return trace
