"""serve — batched HTTP inference server over the KV-cache decode path.

Three engines behind one HTTP API (`--engine`):
  window      requests are bucketed by (prompt length, max_new_tokens,
              temperature), gathered for a short window, and decoded as
              one batch through models/decode.generate;
  continuous  in-flight batching over a fixed pool of decode slots, each
              with its own cache row: new requests are prefilled into
              free slots between decode steps, in bounded chunks;
  paged       continuous batching over a shared KV page pool: slots hold
              only the pages they filled, full prompt pages are shared
              between requests through a prefix cache, and a full pool
              preempts the youngest request.

  POST /generate  {"tokens": [...], "max_new_tokens": 16,
                   "temperature": 0.0, "stream": false}
      stream=true answers as Server-Sent Events: one
      `data: {"token": t}` per generated token, then
      `data: {"done": true, "tokens": [...]}`. The window engine emits
      them when the batch completes; the continuous and paged engines as
      each token is fetched. Events carry a monotonic `ts`, a unix-epoch
      `t` and the request id `req`.
  GET  /healthz

  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny --port 8000
  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny --engine paged

Observability, as in the JAX package (metric names, span names and
dump format shared, so one dashboard and one `trace merge` read both):
every engine feeds a `RequestRecorder` (metrics/request_metrics.py:
TTFT, TPOT, queue wait, slots, KV pages, prefix lookups, the paged
pool's thermal census, and the host-phase split of each tick into
admit / schedule / sample / stream / fetch with `host_gap_fraction`, the
share of wall time in host work not hidden under a running tick: an
upper bound on the card's idle share, since a phase counts hidden only
if the card is still busy when it ends);
`--metrics-port` serves it on /metrics and /debugz (`?kv=1`: the paged
pool's thermal census), `--trace-dump` / `--trace-jsonl` arm the flight
recorder (metrics/events.py) and `--trace-sample-rate` the per-request
spans (metrics/trace.py). A request's `"trace": true` forces it into
the sample; its `"tags": {"tenant": ..., "class": ...}` stamp its spans
and, on the paged engine, own its pages in the thermal census. None of
it waits on the card: the engines read the device only at a prompt's
first token and at each tick's fetch, and the host-phase clock probes
the newest tick with a CUDA event query.

  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny \
      --engine paged --metrics-port 9100 --trace-dump /tmp/traces/

Speculative decoding (`--speculate ngram|draft`, `--spec-k`,
`--draft-layers`; models/spec.py): greedy requests draft k tokens a slot
(prompt lookup, or the model's first layers), score them in one verify
pass of k+1 positions and commit the accepted prefix plus the verifier's
own next token; a tick with a sampled slot runs the plain step. The
continuous and paged engines can split into a decode loop and a pool of
`--prefill-workers` prefill threads, whose chunks a `PrefillBudget`
sizes to about half a decode tick while anything decodes; all of them
launch on one CUDA stream, one at a time under the engine's lock.
`--supervise` arms an `EngineSupervisor`: a dead engine worker has its
requests failed, its slots and pages reclaimed and a fresh worker started
under a bounded exponential backoff; a dead prefill worker is replaced
and no request fails.

  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny \
      --engine paged --speculate ngram --prefill-workers 2 --supervise

Diagnosis and the fleet (metrics/doctor.py, metrics/fleet.py):
`--doctor` runs the streaming doctor over the flight recorder and the
recorder (`--doctor-dir` for its incident bundles; `/debugz?doctor=1`
serves its verdicts), `--fault-listen PATH` trips the faults
`inject_fault --kind ... --fault-log PATH` writes (chaos and tests
only), and `--replica-id` (or TPU_REPLICA_ID) names this replica on the
timeline, the spans, `serve_replica_info` and `/healthz`; `/debugz?state=1`
serves the snapshot fleetmon scrapes.

  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny \
      --engine paged --metrics-port 9100 --doctor --replica-id r0

Device telemetry: `--fabric-health` runs the fabric health monitor
(metrics/fabric_health.py) over this process's group, its gauges on
`--metrics-port` and its block on `/debugz?state=1` (`inject_fault
--kind fabric-slow` throttles it); the continuous and paged engines
record the utils/hbm_plan budget of the launch, which the doctor's
oom_precursor verdicts and OOM bundles carry; TPU_PROFILE_DIR wraps the
session in a torch.profiler capture whose serve/admit,
serve/prefill_chunk and serve/decode_tick regions (utils/profiling.py)
also land on the flight recorder.

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from container_engine_accelerators_tpu_torch.metrics import (
    events,
    introspection,
    trace,
)
from container_engine_accelerators_tpu_torch.metrics.request_metrics import (
    RequestRecorder,
    ServeMetricsExporter,
)
from container_engine_accelerators_tpu_torch.models import spec
from container_engine_accelerators_tpu_torch.models.decode import (
    PageAllocator,
    PrefixIndex,
    advance_lengths,
    assign_pages,
    decode_step_paged,
    decode_step_slots,
    draft_layer_count,
    generate,
    init_paged_cache,
    init_slot_cache,
    merge_tokens,
    pick_tokens,
    prefill_suffix_paged,
    prefill_suffix_slot,
    set_slot_pages,
    verify_step,
)
from container_engine_accelerators_tpu_torch.utils.profiling import (
    annotate,
    maybe_profile,
)

log = logging.getLogger("torch-serve")


def _stream_event(stream, event: dict, rid=None) -> None:
    """Push an event to a request's stream queue (None = not streaming),
    stamped with a monotonic `ts`, a unix-epoch `t` and the request id."""
    if stream is not None:
        ev = dict(event)
        ev["ts"] = time.monotonic()
        ev["t"] = round(time.time(), 6)
        if rid is not None:
            ev["req"] = rid
        stream.put(ev)


def _fail(fut, stream, exc: Exception, rid=None, recorder=None) -> None:
    if not fut.done():
        fut.set_exception(exc)
    _stream_event(stream, {"error": str(exc)}, rid)
    if recorder is not None:
        # A no-op for requests the recorder never saw enqueued
        # (validation rejections count as validation_failures).
        recorder.fail(rid)


def _to_device(values: list, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Host values as a tensor on `device`. On the card the copy goes
    through pinned memory without blocking, so it does not wait for the
    work still queued there (a copy from pageable memory would)."""
    host = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _trace_restart_touch(rid, err: Exception) -> None:
    """Stamp a supervisor-restart instant on a victim request's trace and
    promote it, so its tail buffer reaches the dump."""
    h = trace.handle(rid)
    if h is not None:
        h.promote("supervisor_restart")
        h.instant(trace.EV_SUPERVISOR_RESTART, {"error": str(err)})


def _device_scope(device: torch.device):
    """The engine's card as the calling thread's current CUDA device: the
    kernels' ctypes launches go to the thread's current device, so every
    engine thread, a restarted one included, runs under it."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _validate_request(tokens, max_new_tokens, max_prompt_len, vocab_size,
                      fut, stream, rid=None, recorder=None) -> bool:
    """Fails `fut` (and the stream, so SSE clients see the error instead
    of a hang) and returns False on a bad request. Token ids are range
    checked: an out-of-range embedding index on the card is a device-side
    assert that takes the whole CUDA context down."""
    err = None
    if not tokens or len(tokens) > max_prompt_len:
        err = ValueError(
            f"prompt length must be in [1, {max_prompt_len}]")
    elif max_new_tokens < 1 or max_new_tokens > 1024:
        err = ValueError("max_new_tokens must be in [1, 1024]")
    elif min(tokens) < 0 or max(tokens) >= vocab_size:
        err = ValueError(f"token ids must be in [0, {vocab_size})")
    if err is None:
        return True
    if recorder is not None:
        recorder.validation_failures.inc()
    _fail(fut, stream, err, rid)
    return False


class WorkerKilled(RuntimeError):
    """Raised inside an engine worker by the worker-kill fault: the
    exception unwinds the worker loop and the thread dies with slots
    occupied and futures unresolved, the wreckage a crashed runtime
    leaves. Only the EngineSupervisor (serve --supervise) recovers it."""


def _maybe_injected_hang(engine) -> None:
    """Consume an injected hang or kill (engine.fault_hang_s /
    engine.fault_kill): the worker thread itself sleeps or dies, so the
    failure looks like a real wedge and must be detected, not told."""
    if engine.fault_kill:
        engine.fault_kill = False
        log.warning("injected worker kill: worker thread dying with "
                    "in-flight work abandoned")
        raise WorkerKilled("injected worker kill")
    s, engine.fault_hang_s = engine.fault_hang_s, 0.0
    if s > 0:
        log.warning("injected hang: worker sleeping %.1fs", s)
        time.sleep(s)


class _PhaseClock:
    """Per-tick host-phase stopwatch. Each slice of engine host work is
    attributed to a named phase (admit / schedule / sample / stream /
    fetch) and flagged hidden when it ran under a dispatched-but-unfetched
    tick that was still running on the card: host time that cost the
    card no idle time. The exposed rest over the tick's wall time is the
    recorder's `host_gap_fraction`.

    Hidden is decided by `busy_probe` at the phase's end: the engine's
    `_device_busy`, a CUDA event query on the newest tick in flight (it
    never waits), so a phase counts hidden only when the card was still
    busy as it closed. If the card finished mid-phase, or nothing was in
    flight, the phase is exposed. The fetch is never exposure
    (`exposed=False`): the host waits on device work there; it still
    gives a phase sample."""

    __slots__ = ("rec", "_busy", "_tick_t0", "_exposed")

    def __init__(self, recorder, busy_probe=None):
        self.rec = recorder
        self._busy = busy_probe if busy_probe is not None else (
            lambda: False)
        self._tick_t0 = None
        self._exposed = 0.0

    def start_tick(self) -> None:
        self._tick_t0 = time.monotonic()
        self._exposed = 0.0

    @contextlib.contextmanager
    def phase(self, name: str, exposed: bool | None = None):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            hidden = self._busy() if exposed is None else not exposed
            self.rec.observe_host_phase(name, dt, hidden)
            if not hidden:
                self._exposed += dt

    def commit_tick(self) -> None:
        """Close one tick's exposure accounting; a no-op unless
        start_tick ran (idle iterations never commit, so parked waits do
        not dilute the fraction)."""
        if self._tick_t0 is None:
            return
        self.rec.observe_host_tick(
            self._exposed, time.monotonic() - self._tick_t0)
        self._tick_t0 = None


class BatchingEngine:
    def __init__(self, model, cfg, max_batch: int = 8,
                 window_ms: float = 5.0, max_prompt_len: int = 1024,
                 engine_core: str = "async",
                 recorder: RequestRecorder | None = None,
                 speculate: str = "off", spec_k: int = 4,
                 draft_layers: int = 2):
        if engine_core not in ("async", "sync"):
            raise ValueError(f"engine_core must be 'async' or 'sync', "
                             f"got {engine_core!r}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.max_prompt_len = max_prompt_len
        # Speculative decoding: each greedy batch runs generate()'s
        # speculative loop; a sampled batch runs the plain loop.
        self.speculate = speculate
        self.spec_k = spec_k
        self.draft_layers = draft_layers
        # One recorder can be shared between engines; by default each
        # engine owns a private one.
        self.recorder = recorder if recorder is not None \
            else RequestRecorder()
        self._rid = itertools.count(1)  # request ids (count() is atomic)
        # queue.Queue, not SimpleQueue: the C _queue module's timed get
        # can lose a put's wakeup; _work bounds any residual wait
        # (submit sets it AFTER put).
        self.queue: queue.Queue = queue.Queue()
        self._work = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self.worker_restarts = 0
        # Fault hooks: a nonzero fault_hang_s makes the worker sleep that
        # long at its next loop top (a real hang); fault_kill makes it
        # raise WorkerKilled there, dying with its work abandoned (the
        # supervisor's recovery path).
        self.fault_hang_s = 0.0
        self.fault_kill = False
        # "async" dispatches batch t+1's generate() while batch t still
        # runs on the device and fetches batch t one batch behind;
        # "sync" fetches at once (the token-identity reference path).
        self.engine_core = engine_core
        # In-flight state lives on the engine, not in worker locals.
        self._pending: collections.deque = collections.deque()
        self._batch: list = []
        # Dispatched-but-unfetched batches: {"batch", "out", "done",
        # "stats", "t0"}.
        self._inflight: list = []
        self._stop = threading.Event()
        self._start_worker()

    def _start_worker(self):
        """(Re)create the worker thread: __init__ and the supervisor's
        restart share this."""
        self.thread = threading.Thread(target=self._worker, daemon=True,
                                       name="serve-batcher")
        self.thread.start()

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float, stream: queue.Queue | None = None,
               trace_ctx: dict | None = None) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        rid = next(self._rid)
        if not _validate_request(tokens, max_new_tokens,
                                 self.max_prompt_len, self.cfg.vocab_size,
                                 fut, stream, rid=rid,
                                 recorder=self.recorder):
            return fut
        # The trace starts before enqueue, so the client's force and tags
        # land on the handle the recorder's enqueue reuses.
        if trace_ctx:
            trace.start(rid, force=bool(trace_ctx.get("force")),
                        tags=trace_ctx.get("tags"))
        self.recorder.enqueue(rid)
        self.queue.put((tuple(tokens), max_new_tokens, temperature, fut,
                        stream, rid))
        self._work.set()  # after put: the worker's drain must see it
        return fut

    def stop(self):
        self._stop.set()
        self._work.set()  # wake an idle worker so it can exit promptly

    def recover_after_worker_death(self, err: Exception) -> None:
        """Fail every request the dead worker abandoned (the batches in
        flight, the batch being gathered, parked and queued requests)
        and zero the slot gauge. The supervisor calls it before it
        restarts the worker; clients get an error, not a hang."""
        inflight = [item for fl in self._inflight for item in fl["batch"]]
        for item in inflight + self._batch + list(self._pending):
            _trace_restart_touch(item[5], err)
            _fail(item[3], item[4], err, item[5], self.recorder)
        self._inflight = []
        self._batch = []
        self._pending.clear()
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            _trace_restart_touch(item[5], err)
            _fail(item[3], item[4], err, item[5], self.recorder)
        self._work.clear()
        self.recorder.set_slots(active=0, total=self.max_batch)

    # ---------- worker ----------

    @staticmethod
    def _bucket_key(item):
        tokens, n_new, temp = item[0], item[1], item[2]
        # One batch decodes with a single temperature.
        return (len(tokens), n_new, temp)

    def _worker(self):
        with _device_scope(self.device):
            self._batch_loop()

    def _batch_loop(self):
        clock = _PhaseClock(self.recorder, self._device_busy)
        pending = self._pending
        while not self._stop.is_set():
            _maybe_injected_hang(self)
            # Only block for new traffic when nothing is deferred, and
            # never while a batch is in flight: its results must land.
            if not pending:
                if not self._inflight:
                    self._work.wait(0.1)
                self._work.clear()
                try:
                    pending.append(self.queue.get_nowait())
                except queue.Empty:
                    if self._inflight:
                        clock.start_tick()
                        self._drain_batches(clock)
                        clock.commit_tick()
                    continue
            # Gather same-bucket requests for one window.
            deadline = time.monotonic() + self.window
            key = self._bucket_key(pending[0])
            batch = self._batch = [pending.popleft()]
            # Single-pass partition of parked requests: same-bucket items
            # join, the rest rotate back; FIFO holds within each bucket.
            for _ in range(len(pending)):
                item = pending.popleft()
                if (len(batch) < self.max_batch
                        and self._bucket_key(item) == key):
                    batch.append(item)
                else:
                    pending.append(item)
            while len(batch) < self.max_batch:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._work.wait(min(remaining, 0.05))
                    self._work.clear()
                    continue
                if self._bucket_key(item) == key:
                    batch.append(item)
                else:
                    pending.append(item)

            rec = self.recorder
            clock.start_tick()
            with clock.phase("admit"):
                for item in batch:
                    rec.admit(item[5])
                rec.set_slots(active=len(batch), total=self.max_batch)
            n_new, temp = batch[0][1], batch[0][2]
            t_batch = time.monotonic()
            try:
                with annotate("serve/decode_tick"), \
                        clock.phase("schedule"):
                    tokens = _to_device([list(item[0]) for item in batch],
                                        torch.long, self.device)
                    gen = None
                    if temp > 0:
                        gen = torch.Generator(
                            device=self.device).manual_seed(
                                time.time_ns() & 0xFFFF)
                    stats: dict = {}
                    # Dispatch only: the plain generate() never waits for
                    # the device (the speculative one reads each round's
                    # argmax).
                    out = generate(self.model, tokens, self.cfg, n_new,
                                   temperature=temp, generator=gen,
                                   speculate=(self.speculate if temp <= 0
                                              else "off"),
                                   spec_k=self.spec_k,
                                   draft_layers=self.draft_layers,
                                   spec_stats=stats)
                    done = None
                    if self.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
            except Exception as e:
                introspection.note_failure(e, "serve/window_batch")
                log.exception("batch failed")
                for item in batch:
                    _fail(item[3], item[4], e, item[5], rec)
                self._batch = []
                rec.set_slots(active=0, total=self.max_batch)
                continue
            self._inflight.append({"batch": batch, "out": out,
                                   "done": done, "stats": stats,
                                   "t0": t_batch})
            for item in batch:
                h = trace.handle(item[5])
                if h is not None:
                    h.instant(trace.EV_DISPATCH,
                              {"batch": len(batch), "n_new": n_new})
            self._batch = []
            self._drain_batches(clock, keep=1 if self.engine_core == "async"
                                else 0)
            clock.commit_tick()

    def _device_busy(self) -> bool:
        """True while the newest dispatched-but-unfetched batch still
        runs on the device. Non-blocking: an Event query."""
        if not self._inflight:
            return False
        done = self._inflight[-1]["done"]
        return done is not None and not done.query()

    def _drain_batches(self, clock, keep: int = 0) -> None:
        """Fetch outstanding batches until at most `keep` remain; zero
        the slot gauge once nothing is in flight."""
        while len(self._inflight) > keep:
            self._fetch_batch(clock)
        if not self._inflight:
            self.recorder.set_slots(active=0, total=self.max_batch)

    def _fetch_batch(self, clock) -> None:
        """Bring the OLDEST dispatched batch to the host (the engine's
        only wait on the device) and deliver its results and streams."""
        rec = self.recorder
        fl = self._inflight.pop(0)
        batch = fl["batch"]
        handles = [trace.handle(item[5]) for item in batch]
        t_fetch = time.monotonic()
        try:
            with clock.phase("fetch", exposed=False):
                out_host = fl["out"].tolist()
        except Exception as e:
            # Device errors of an asynchronous dispatch surface here.
            introspection.note_failure(e, "serve/window_batch")
            log.exception("batch failed")
            for item in batch:
                _fail(item[3], item[4], e, item[5], rec)
            return
        stats = fl["stats"]
        if stats:
            rec.observe_spec(drafted=stats.get("drafted", 0),
                             accepted=stats.get("accepted", 0),
                             verifies=stats.get("verifies", 0),
                             committed=stats.get("committed", 0))
        batch_dt = time.monotonic() - fl["t0"]
        t_streamed = time.monotonic()
        for h in handles:
            if h is not None:
                h.begin(trace.SPAN_FETCH, ts=t_fetch)
                h.end(trace.SPAN_FETCH, ts=t_streamed)
                h.begin(trace.SPAN_STREAM, ts=t_streamed)
        with clock.phase("stream"):
            for item, row in zip(batch, out_host):
                rid = item[5]
                item[3].set_result(row)
                # No incremental tokens here: the client's TTFT is the
                # batch's completion, and TPOT amortizes the batch time
                # over the generated tokens (the observation counts stay
                # those of the other engines).
                rec.first_token(rid)
                n_gen = len(row) - len(item[0])
                for _ in range(n_gen - 1):
                    rec.observe_tpot(batch_dt / max(n_gen, 1))
                if item[4] is not None:
                    for tok in row[len(item[0]):]:
                        _stream_event(item[4], {"token": tok}, rid)
                    _stream_event(item[4], {"done": True, "tokens": row},
                                  rid)
                h = trace.handle(rid)
                if h is not None:
                    h.end(trace.SPAN_STREAM)
                rec.finish(rid)
        self.batches_run += 1
        self.requests_served += len(batch)


class PrefillBudget:
    """Token budget of the prefill pool (--prefill-workers).

    Each grant answers "how many prompt tokens may the prefill pool
    forward now without breaking decode's tick cadence": while any slot
    decodes, the grant is sized so one chunk costs about `slack_frac` of
    a decode tick (from moving averages of the observed decode tick and
    the prefill cost a token), floored at one prompt bucket, so prefill
    always progresses, and capped at the engine's prefill_chunk. With
    nothing decoding there is no cadence to protect and the whole chunk
    is granted. Grants are prompt-bucket multiples.

    Host-side and lock-free (the engine serializes callers)."""

    def __init__(self, bucket: int, chunk: int,
                 slack_frac: float = 0.5):
        self.bucket = max(int(bucket), 1)
        self.chunk = int(chunk) if chunk else 0
        self.slack_frac = slack_frac
        self._decode_s: float | None = None  # EMA decode-tick seconds
        self._tok_s: float | None = None     # EMA prefill seconds a token

    @staticmethod
    def _ema(old, new, alpha=0.2):
        return new if old is None else (1 - alpha) * old + alpha * new

    def note_decode(self, seconds: float) -> None:
        self._decode_s = self._ema(self._decode_s, seconds)

    def note_prefill(self, tokens: int, seconds: float) -> None:
        if tokens > 0:
            self._tok_s = self._ema(self._tok_s, seconds / tokens)

    def grant(self, decoding: bool) -> int:
        """The most prompt tokens the next prefill chunk may take."""
        cap = self.chunk if self.chunk else (1 << 30)
        if not decoding:
            return cap
        n = self.bucket
        if self._decode_s and self._tok_s:
            n = int(self._decode_s * self.slack_frac / self._tok_s)
            n = (n // self.bucket) * self.bucket
        return max(self.bucket, min(n, cap))


class ContinuousEngine:
    """In-flight (continuous) batching: a fixed pool of decode slots
    steps together every iteration, and new requests are prefilled into
    free slots between steps, joining the running batch at once instead
    of waiting for it to drain. Each slot owns one row of a slot cache
    ([slots, max_len] positions); a free slot still computes, and its
    output is thrown away.

    One worker thread runs the loop: pump the queue, admit from the
    backlog, run at most one prompt chunk (`prefill_chunk` tokens, 0 =
    the whole prompt) of the oldest prefilling slot, `_pre_step` (the
    paged engine's page growth), then one decode tick. Prompts pad to
    `prompt_bucket` multiples.

    Cores: "async" (the default) dispatches tick t+1 while tick t runs
    on the device and fetches tick t one tick behind; the slots' last
    tokens stay on the device between ticks, with host-sampled first
    tokens merged in by merge_tokens. "sync" fetches every tick at once
    (the token-identity reference). The engine reads the device at two
    points only: the first token after a prompt's final chunk, and
    `_fetch_tick` (a speculative tick also reads its verify).

    Speculative decoding (`speculate` 'ngram' or 'draft'): a tick where
    every decoding slot is greedy and has k+1 positions of room drafts
    `spec_k` tokens a slot and scores them in one verify pass; any other
    tick is the plain one-token tick. The draft model's cache is a slot
    cache, also under the paged engine.

    Pools (`prefill_workers` > 0): the worker keeps admission and the
    decode ticks, and that many prefill threads run the prompt chunks,
    each sized by a PrefillBudget, at most one a decode tick while
    anything decodes. The core is then "sync". Every thread launches on
    the card's one stream, under `_mu`: the kernels keep tickets per
    device, so no two calls may run on two streams at once.

    PagedContinuousEngine overrides the policy hooks (admission, page
    growth, preemption, release); the control flow lives here.
    `plain=True` runs the kernels' plain versions on any device (the
    on-card reference for the kernel path).

    Each loop iteration holds `_mu` from admission to the decode tick,
    so a reader on another thread (the paged engine's thermal census
    for /debugz) sees the slot table and page pool between iterations,
    never mid-change; the idle wait does not hold it."""

    def __init__(self, model, cfg, max_slots: int = 8,
                 max_len: int = 2048, prompt_bucket: int = 64,
                 max_prompt_len: int = 1024, prefill_chunk: int = 0,
                 prefill_workers: int = 0,
                 engine_core: str = "async", plain: bool = False,
                 recorder: RequestRecorder | None = None,
                 speculate: str = "off", spec_k: int = 4,
                 draft_layers: int = 2):
        if engine_core not in ("async", "sync"):
            raise ValueError(f"engine_core must be 'async' or 'sync', "
                             f"got {engine_core!r}")
        if speculate not in ("off", "ngram", "draft"):
            raise ValueError(f"speculate must be 'off', 'ngram' or "
                             f"'draft', got {speculate!r}")
        if speculate != "off" and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.max_prompt_len = max_prompt_len
        if prefill_chunk:
            # Non-final chunks set the next chunk's start, so they end on
            # bucket boundaries.
            prefill_chunk = -(-prefill_chunk // prompt_bucket) * prompt_bucket
        self.prefill_chunk = prefill_chunk
        self.speculate = speculate
        self.spec_k = spec_k
        self.spec_ticks_run = 0
        self._spec_tick = False
        self.prefill_workers = max(int(prefill_workers), 0)
        self._budget = PrefillBudget(prompt_bucket, self.prefill_chunk)
        # Pools run synchronously: the decode tick and the prefill chunks
        # take turns under _mu from different threads, and a trailing
        # fetch would keep the slot bookkeeping stale across turns.
        if self.prefill_workers:
            engine_core = "sync"
        self.engine_core = engine_core
        self.plain = plain
        self.recorder = recorder if recorder is not None \
            else RequestRecorder()
        self._rid = itertools.count(1)
        # Dispatched-but-unfetched decode ticks, oldest first: {"toks",
        # "slots": [(slot, final)], "done": CUDA event or None, "t0":
        # dispatch time}.
        self._inflight: list = []
        # Device-resident last-token vector (async core) and the
        # host-known tokens to merge into it at the next dispatch.
        self._dev_tok = None
        self._tok_overrides: dict = {}
        self._clock = _PhaseClock(self.recorder, self._device_busy)
        # RLock: recovery re-enters it.
        self._mu = threading.RLock()
        self._prefill_work = threading.Event()
        self._prefill_threads: list[threading.Thread] = []
        self.prefill_worker_restarts = 0
        # Pools: while anything decodes, at most one budgeted chunk a
        # decode tick (locks are not fair: a busy pool could otherwise
        # take _mu ahead of the waiting decode loop every time).
        self._chunks_this_tick = 0
        # queue.Queue + Event wake, as in BatchingEngine.
        self.queue: queue.Queue = queue.Queue()
        self._work = threading.Event()
        # Fault hooks, as BatchingEngine's; fault_kill_prefill kills one
        # prefill worker at the next moment a prompt is mid-prefill.
        self.fault_hang_s = 0.0
        self.fault_kill = False
        self.fault_kill_prefill = False
        self.worker_restarts = 0
        self.steps_run = 0          # decode ticks (all slots at once)
        self.prefills_run = 0       # completed request prefills
        self.prefill_chunks_run = 0
        # Prompt tokens forwarded by prefill chunks: prefix-cache hits
        # skip their shared pages, so this stays below the summed prompt
        # lengths by exactly the reused tokens.
        self.prefill_tokens_run = 0
        # steps_run at each chunk: decode keeps ticking between the
        # chunks of one long prompt.
        self.prefill_chunk_trace: list[int] = []
        self.requests_served = 0
        self.batches_run = 0        # = steps_run, for /healthz
        self._stop = threading.Event()
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        if speculate == "draft":
            n_draft = draft_layer_count(cfg, draft_layers)
            self._draft_cfg = spec.draft_config(cfg, n_draft)
            self._draft_model = spec.truncate_params(model, n_draft)
        # The slot table and cache exist before the worker starts, so a
        # reader on another thread (the census) never sees them missing.
        self._fresh_slots()
        self._fresh_state()
        self._start_worker()

    def _start_worker(self):
        """(Re)create the worker thread: __init__ and the supervisor's
        restart share this. The slot table and cache are the engine's,
        rebuilt by recover_after_worker_death, not by the thread."""
        self.thread = threading.Thread(target=self._worker, daemon=True,
                                       name="serve-continuous")
        self.thread.start()

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float, stream: queue.Queue | None = None,
               trace_ctx: dict | None = None) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        rid = next(self._rid)
        if not _validate_request(tokens, max_new_tokens,
                                 self.max_prompt_len, self.cfg.vocab_size,
                                 fut, stream, rid=rid,
                                 recorder=self.recorder):
            return fut
        # The prompt is padded up to a bucket multiple before prefill,
        # so the bucketed length must fit the cache too.
        bucketed = -(-len(tokens) // self.prompt_bucket) * self.prompt_bucket
        if (len(tokens) + max_new_tokens > self.max_len
                or bucketed > self.max_len):
            self.recorder.validation_failures.inc()
            _fail(fut, stream, ValueError(
                f"prompt (bucketed to {bucketed}) + max_new_tokens "
                f"exceeds cache max_len {self.max_len}"), rid)
            return fut
        # Before enqueue: the recorder's enqueue reuses this handle.
        if trace_ctx:
            trace.start(rid, force=bool(trace_ctx.get("force")),
                        tags=trace_ctx.get("tags"))
            self._note_tenant(rid, trace_ctx.get("tags"))
        self.recorder.enqueue(rid)
        self.queue.put((tuple(tokens), max_new_tokens, temperature, fut,
                        stream, rid))
        self._work.set()  # after put: the worker's drain must see it
        return fut

    def stop(self):
        self._stop.set()
        self._work.set()
        self._prefill_work.set()

    def recover_after_worker_death(self, err: Exception) -> None:
        """Fail every request the dead worker abandoned (occupied slots,
        the backlog, everything queued), drop the ticks in flight and the
        device token vector, and rebuild the slot table, the cache (and
        the paged engine's allocator and prefix index) and the draft
        cache, so the restarted worker starts on a clean pool. The
        supervisor calls it before the restart. Under _mu: live prefill
        workers and the census never see the state half rebuilt."""
        with self._mu:
            self._inflight = []
            self._dev_tok = None
            self._tok_overrides = {}
            self._spec_tick = False
            for sl in self._slots:
                if sl is not None:
                    _trace_restart_touch(sl["rid"], err)
                    _fail(sl["fut"], sl["stream"], err, sl["rid"],
                          self.recorder)
            for item in self._backlog:
                _trace_restart_touch(item[5], err)
                _fail(item[3], item[4], err, item[5], self.recorder)
            while True:
                try:
                    item = self.queue.get_nowait()
                except queue.Empty:
                    break
                _trace_restart_touch(item[5], err)
                _fail(item[3], item[4], err, item[5], self.recorder)
            self._work.clear()
            self._fresh_slots()
            self._fresh_state()
            self._record_occupancy()

    # ---------- hooks (overridden by the paged engine) ----------

    def _note_tenant(self, rid: int, tags: dict | None) -> None:
        """Tenant attribution: the paged engine records a request's
        tenant and class tags so its pages carry an owner in the thermal
        census. A no-op on the slot engine."""

    def _record_occupancy(self):
        """Occupancy gauges, once an iteration (the paged engine adds
        the page pool's)."""
        self.recorder.set_slots(
            active=sum(sl is not None for sl in self._slots),
            total=self.max_slots)

    def _fresh_slots(self):
        self._slots: list[dict | None] = [None] * self.max_slots
        self._backlog: list = []
        self._last_tok = [0] * self.max_slots
        self._temps = [0.0] * self.max_slots
        self._admit_seq = 0

    def _fresh_state(self):
        # The old cache goes first, so the card never holds two.
        self._cache = None
        self._cache = init_slot_cache(self.cfg, self.max_slots,
                                      self.max_len, self.device)
        self._fresh_draft_state()

    def _fresh_draft_state(self):
        if self.speculate != "draft":
            return
        self._draft_cache = None
        self._draft_cache = init_slot_cache(self._draft_cfg, self.max_slots,
                                            self.max_len, self.device)

    def _admit_one(self, item, slot_idx) -> bool:
        """Register the request in a free slot; its prompt runs in the
        prefill ticks. False = no resources now, retry next loop (the
        item stays in the backlog)."""
        tokens, n_new, temp, fut, stream, rid = item
        self._admit_seq += 1
        self._slots[slot_idx] = {
            "fut": fut, "stream": stream, "remaining": n_new,
            "out": list(tokens), "temp": temp,
            "pending": list(tokens), "len": 0,
            "admitted": self._admit_seq, "rid": rid}
        self._last_tok[slot_idx] = 0
        self._temps[slot_idx] = temp
        return True

    def _run_chunk(self, slot_idx: int, tokens: torch.Tensor, start: int,
                   new_len: int) -> torch.Tensor:
        last, self._cache = prefill_suffix_slot(
            self.model, self._cache, slot_idx, tokens, start, new_len,
            self.cfg, plain=self.plain)
        return last

    def _step(self, tokens: torch.Tensor, active: torch.Tensor
              ) -> torch.Tensor:
        logits, self._cache = decode_step_slots(self.model, self._cache,
                                                tokens, active, self.cfg,
                                                plain=self.plain)
        return logits

    def _on_prefill_complete(self, slot_idx: int, sl: dict) -> None:
        pass

    def _pre_step(self) -> bool:
        """Between the prefill and decode ticks (paged: page growth).
        Decides whether the coming tick speculates, before it runs, so
        the paged engine can back the verify window with pages. False =
        a device error was handled; skip the decode tick."""
        self._spec_tick = self._want_spec_tick()
        return True

    def _want_spec_tick(self) -> bool:
        """Speculate this tick iff every decoding slot is greedy and has
        room for the verify's k+1 uncommitted writes, and at least one
        still wants more than one token (a one-token tail is cheaper on
        the plain tick)."""
        if self.speculate == "off":
            return False
        k1 = self.spec_k + 1
        dec = [sl for sl in self._slots
               if sl is not None and not sl["pending"]]
        if not dec:
            return False
        return (all(sl["temp"] <= 0 and sl["len"] + k1 <= self.max_len
                    for sl in dec)
                and any(sl["remaining"] > 1 for sl in dec))

    def _release_slot(self, slot_idx: int) -> None:
        pass

    # ---------- worker ----------

    def _worker(self):
        with _device_scope(self.device):
            if self.prefill_workers:
                self._decode_pool_loop()
            else:
                self._loop()

    def _loop(self):
        # While tick t runs on the card, this iteration's admission,
        # prefill and page growth run in the gap, tick t+1 dispatches
        # behind it, and only then is tick t fetched (async core). The
        # phase clock attributes each host slice and flags it hidden
        # when a tick was still running.
        clock = self._clock
        while not self._stop.is_set():
            _maybe_injected_hang(self)
            self._pump_queue()
            with self._mu:
                clock.start_tick()
                with annotate("serve/admit"), clock.phase("admit"):
                    self._admit_phase()
                self._record_occupancy()
                if all(sl is None for sl in self._slots):
                    continue
                with annotate("serve/prefill_chunk"), \
                        clock.phase("schedule"):
                    self._prefill_tick()
                with clock.phase("schedule"):
                    ok = self._pre_step()
                if not ok:
                    continue
                with annotate("serve/decode_tick"):
                    if self._decode_tick():
                        clock.commit_tick()

    def _pump_queue(self):
        # No timed queue-get: drain without blocking and park on an
        # Event that submit() sets after its put.
        if all(sl is None for sl in self._slots) and not self._backlog:
            self._work.wait(0.05)
        self._work.clear()
        self._drain_queue()

    def _drain_queue(self):
        while True:
            try:
                self._backlog.append(self.queue.get_nowait())
            except queue.Empty:
                return

    # ---------- pools (prefill_workers > 0) ----------

    def _decode_pool_loop(self):
        """The decode loop of the pools layout: admission and the tick
        cadence; the prefill pool runs the chunks within the budget's
        grant. Every shared-state phase holds _mu; the idle waits do
        not (a parked decode loop must never block a prefill chunk)."""
        self._ensure_prefill_threads()
        while not self._stop.is_set():
            _maybe_injected_hang(self)
            with self._mu:
                idle = (all(sl is None for sl in self._slots)
                        and not self._backlog)
            if idle:
                self._work.wait(0.05)
            self._work.clear()
            with self._mu:
                self._drain_queue()
                with annotate("serve/admit"):
                    self._admit_phase()
                self._record_occupancy()
                n_prefilling = sum(sl is not None and bool(sl["pending"])
                                   for sl in self._slots)
                n_decoding = sum(sl is not None and not sl["pending"]
                                 for sl in self._slots)
                # The prefill pool owns the backlog and every slot still
                # holding prompt tokens; decode owns the ticking slots.
                self.recorder.set_pool_depths(
                    prefill=len(self._backlog) + n_prefilling,
                    decode=n_decoding)
            if n_prefilling:
                self._prefill_work.set()
            if not n_decoding:
                # No cadence to protect: park briefly. A prefill worker
                # sets _work when a slot's first token lands.
                if n_prefilling or not idle:
                    self._work.wait(0.005)
                continue
            with self._mu:
                if not self._pre_step():
                    continue
                with annotate("serve/decode_tick"):
                    self._decode_tick()
                self._chunks_this_tick = 0  # the tick paid: a new grant
            if n_prefilling:
                self._prefill_work.set()

    def _prefill_worker(self):
        """A prefill-pool worker: runs budgeted chunks of the oldest
        prefilling slot under _mu. An injected kill raises between
        chunks with _mu released, so a dying worker leaves no lock held
        and no slot or page half changed: the replacement resumes the
        pending prompts where they stopped."""
        with _device_scope(self.device):
            while not self._stop.is_set():
                if self.fault_kill_prefill:
                    self._maybe_killed_prefill()
                with self._mu:
                    with annotate("serve/prefill_chunk"):
                        did = self._prefill_tick()
                if not did:
                    self._prefill_work.wait(0.01)
                    self._prefill_work.clear()

    def _maybe_killed_prefill(self) -> None:
        """Consume an armed prefill kill when a prompt is mid-prefill
        (dying while idle would exercise nothing), stamping the victims
        at the moment of death, then raise with _mu released."""
        with self._mu:
            victims = [sl for sl in self._slots
                       if sl is not None and sl["pending"]]
            if not (victims and self.fault_kill_prefill):
                return
            self.fault_kill_prefill = False
            for sl in victims:
                h = trace.handle(sl["rid"])
                if h is not None:
                    h.promote("pool_restart")
                    h.instant(trace.EV_POOL_RESTART, {"injected": True})
        log.warning("injected prefill-pool worker kill: thread dying "
                    "between chunks")
        raise WorkerKilled("injected prefill worker kill")

    def _ensure_prefill_threads(self):
        """Top the pool up to `prefill_workers` live threads."""
        self._prefill_threads = [t for t in self._prefill_threads
                                 if t.is_alive()]
        while len(self._prefill_threads) < self.prefill_workers:
            t = threading.Thread(
                target=self._prefill_worker, daemon=True,
                name=f"serve-prefill-{len(self._prefill_threads)}")
            t.start()
            self._prefill_threads.append(t)

    def prefill_workers_alive(self) -> int:
        return sum(t.is_alive() for t in self._prefill_threads)

    def restart_dead_prefill_workers(self) -> int:
        """Supervisor entry: replace dead prefill workers and return how
        many. Partial recovery: no request fails and no page moves, since
        the slot and page state is the engine's and a killed worker dies
        between chunks; the replacements resume the pending prompts."""
        if not self.prefill_workers or self._stop.is_set():
            return 0
        with self._mu:
            dead = sum(1 for t in self._prefill_threads
                       if not t.is_alive())
            if not dead:
                return 0
            self._ensure_prefill_threads()
            self.prefill_worker_restarts += dead
            for sl in self._slots:
                if sl is not None and sl["pending"]:
                    h = trace.handle(sl["rid"])
                    if h is not None:
                        h.promote("pool_restart")
                        h.instant(trace.EV_POOL_RESTART,
                                  {"dead_workers": dead})
        self._prefill_work.set()
        return dead

    # ---------- the ticks ----------

    def _admit_phase(self):
        free = [i for i in range(self.max_slots) if self._slots[i] is None]
        while self._backlog and free:
            item = self._backlog[0]
            try:
                if not self._admit_one(item, free[0]):
                    return  # resources exhausted: retry next loop
            except Exception as e:
                introspection.note_failure(e, "serve/admit")
                log.exception("admission failed")
                self._backlog.pop(0)
                _fail(item[3], item[4], e, item[5], self.recorder)
                self._reset(e)
                return
            self._backlog.pop(0)
            if self._slots[free[0]] is not None:  # actually admitted
                self.recorder.admit(item[5])
                free.pop(0)

    def _prefill_tick(self) -> bool:
        """Run ONE prompt chunk of the oldest still-prefilling slot; on
        the final chunk, sample the request's first token and move the
        slot to decoding. True iff a chunk ran (a prefill worker parks
        on False). The chunk is --prefill-chunk tokens on the single
        loop, the budget's grant in the pools layout."""
        cand = [i for i, sl in enumerate(self._slots)
                if sl is not None and sl["pending"]]
        if not cand:
            return False
        i = min(cand, key=lambda j: self._slots[j]["admitted"])
        sl = self._slots[i]
        take = len(sl["pending"])
        if self.prefill_workers:
            decoding = any(s is not None and not s["pending"]
                           for s in self._slots)
            if decoding and self._chunks_this_tick:
                return False  # this tick's grant is spent
            take = min(self._budget.grant(decoding), take)
        elif self.prefill_chunk:
            take = min(self.prefill_chunk, take)
        final = take == len(sl["pending"])
        bucketed = -(-take // self.prompt_bucket) * self.prompt_bucket
        padded = sl["pending"][:take] + [0] * (bucketed - take)
        start, new_len = sl["len"], sl["len"] + take
        h = trace.handle(sl["rid"])
        if h is not None:
            h.begin(trace.SPAN_PREFILL_CHUNK,
                    {"tokens": take, "final": final,
                     "pool": bool(self.prefill_workers)})
        t_chunk = time.monotonic()
        try:
            chunk = _to_device(padded, torch.long, self.device)
            last_logits = self._run_chunk(i, chunk, start, new_len)
            if self.speculate == "draft":
                # Mirror the chunk into the drafter's slot cache, so its
                # prefix matches the main cache position for position.
                # On a paged prefix hit the shared pages' tokens were
                # never forwarded and the draft cache has no K/V there:
                # drafts degrade, and the verifier keeps the output
                # exact (a wrong draft is rejected, never emitted).
                _, self._draft_cache = prefill_suffix_slot(
                    self._draft_model, self._draft_cache, i, chunk, start,
                    new_len, self._draft_cfg, plain=self.plain)
            if final:
                temps = _to_device([sl["temp"]], torch.float32, self.device)
                # The first token is read at once (it streams the time to
                # first token); it joins the device token vector through
                # merge_tokens at the next dispatch.
                tok = int(pick_tokens(last_logits[None, :], temps,
                                      self._gen)[0])
        except Exception as e:
            # The bundle first: _reset rebuilds the pool, destroying the
            # evidence.
            introspection.note_failure(e, "serve/prefill_chunk")
            log.exception("prefill chunk failed")
            self._reset(e)
            return False
        if h is not None:
            h.end(trace.SPAN_PREFILL_CHUNK)
        self._budget.note_prefill(take, time.monotonic() - t_chunk)
        self._chunks_this_tick += 1
        sl["pending"] = sl["pending"][take:]
        sl["len"] = new_len
        self.prefill_chunks_run += 1
        self.prefill_tokens_run += take
        self.prefill_chunk_trace.append(self.steps_run)
        self.recorder.observe_prefill_chunk(take)
        if not final:
            return True
        self._on_prefill_complete(i, sl)
        self.prefills_run += 1
        sl["out"].append(tok)
        sl["remaining"] -= 1
        self._last_tok[i] = tok
        self._tok_overrides[i] = tok
        # Stamped where the token already reached the host (int() above).
        self.recorder.first_token(sl["rid"])
        _stream_event(sl["stream"], {"token": tok}, sl["rid"])
        if sl["remaining"] <= 0:
            self._finish(i)
        elif self.prefill_workers:
            # The slot just became decodable: wake a parked decode loop.
            self._work.set()
        return True

    def _decode_tick(self) -> bool:
        """Dispatch one decode step over every decoding slot (prefilling
        slots stay inactive). Counts (lengths, remaining budgets) move at
        dispatch, so the next iteration's masks and page growth see the
        state after the tick; the token values land in `_fetch_tick`,
        one tick later on the async core, at once on the sync core.
        True iff a tick was dispatched or an outstanding one fetched."""
        if self._spec_tick:
            self._spec_tick = False
            # A speculative round reads its verify on the host and drafts
            # from the host's history, so the pipeline drains first:
            # _last_tok and the outputs must be current, and no tick in
            # flight may hold a `final` pinned before the round moves
            # `remaining`.
            self._drain_inflight()
            if self._spec_decode_tick():
                return True
        decoding = [sl is not None and not sl["pending"]
                    and sl["remaining"] > 0 for sl in self._slots]
        if not any(decoding):
            # Nothing to dispatch: land what is still in flight (slots
            # whose budget ran out finish inside the fetch).
            fetched = bool(self._inflight)
            self._drain_inflight()
            return fetched
        dev = self.device
        with self._clock.phase("schedule"):
            t_step = time.monotonic()
            try:
                if self._dev_tok is None:
                    tokens = _to_device(self._last_tok, torch.long, dev)
                elif self._tok_overrides:
                    ov = [self._tok_overrides.get(i, 0)
                          for i in range(self.max_slots)]
                    mk = [i in self._tok_overrides
                          for i in range(self.max_slots)]
                    tokens = merge_tokens(self._dev_tok,
                                          _to_device(ov, torch.long, dev),
                                          _to_device(mk, torch.bool, dev))
                else:
                    tokens = self._dev_tok
                self._tok_overrides = {}
                logits = self._step(tokens,
                                    _to_device(decoding, torch.bool, dev))
                toks = pick_tokens(
                    logits, _to_device(self._temps, torch.float32, dev),
                    self._gen)
                done = None
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            except Exception as e:
                introspection.note_failure(e, "serve/decode_tick")
                log.exception("decode step failed")
                self._reset(e)
                return False
        with self._clock.phase("sample"):
            self.steps_run += 1
            self.batches_run = self.steps_run
            if self.engine_core == "async":
                self._dev_tok = toks
            # Whether this tick is a slot's last is pinned here: by fetch
            # time a later dispatch may have moved `remaining` on.
            ticked = []
            for i, sl in enumerate(self._slots):
                if not decoding[i]:
                    continue
                sl["len"] = min(sl["len"] + 1, self.max_len)
                sl["remaining"] -= 1
                ticked.append((i, sl["remaining"] <= 0))
                h = trace.handle(sl["rid"])
                if h is not None:
                    h.instant(trace.EV_DISPATCH,
                              {"tick": self.steps_run}, ts=t_step)
            self._inflight.append({"toks": toks, "slots": ticked,
                                   "done": done, "t0": t_step})
        keep = 1 if self.engine_core == "async" else 0
        while len(self._inflight) > keep:
            self._fetch_tick()
        return True

    def _fetch_tick(self) -> None:
        """Bring the OLDEST outstanding tick's tokens to the host (the
        async core's one wait on the device, made with the next tick
        already queued) and deliver them: outputs, the host token
        mirror, streams, finished slots."""
        if not self._inflight:
            return
        fl = self._inflight.pop(0)
        t_f0 = time.monotonic()
        try:
            with self._clock.phase("fetch", exposed=False):
                toks = fl["toks"].tolist()
        except Exception as e:
            # Device errors of an asynchronous dispatch surface here.
            introspection.note_failure(e, "serve/decode_tick")
            log.exception("decode step failed")
            self._reset(e)
            return
        # Dispatch to fetch: the tick's device time plus the host work
        # hidden under it, the pipelined tick's wall time.
        t_f1 = time.monotonic()
        t_tick = t_f1 - fl["t0"]
        self.recorder.observe_decode_step(t_tick)
        self._budget.note_decode(t_tick)
        with self._clock.phase("stream"):
            for i, final in fl["slots"]:
                sl = self._slots[i]
                if sl is None:
                    continue  # reclaimed by a reset before the fetch
                h = trace.handle(sl["rid"])
                if h is not None:
                    h.begin(trace.SPAN_FETCH, {"tick_ms": round(
                        t_tick * 1e3, 3)}, ts=t_f0)
                    h.end(trace.SPAN_FETCH, ts=t_f1)
                    h.begin(trace.SPAN_STREAM)
                tok = toks[i]
                sl["out"].append(tok)
                self._last_tok[i] = tok
                self.recorder.decode_token(sl["rid"])
                _stream_event(sl["stream"], {"token": tok}, sl["rid"])
                if h is not None:
                    h.end(trace.SPAN_STREAM)
                if final:
                    self._finish(i)

    def _drain_inflight(self) -> None:
        """Fetch every outstanding tick (speculation and preemption need
        the host view current)."""
        while self._inflight:
            self._fetch_tick()

    def _device_busy(self) -> bool:
        """True while the newest dispatched-but-unfetched tick still runs
        on the device. Non-blocking: an Event query."""
        if not self._inflight:
            return False
        done = self._inflight[-1]["done"]
        return done is not None and not done.query()

    def _verify(self, tokens: torch.Tensor, active: torch.Tensor
                ) -> torch.Tensor:
        """The verify pass over [slots, k+1] tokens; returns its logits,
        the cache's lengths unmoved."""
        logits, self._cache = verify_step(self.model, self._cache, tokens,
                                          active, self.cfg,
                                          plain=self.plain)
        return logits

    def _spec_decode_tick(self) -> bool:
        """One draft + verify + commit round over every decoding slot:
        spec_k drafts a slot, ONE verify pass of k+1 positions over the
        model, greedy acceptance on the host, one advance_lengths commit.
        Returns False, having run nothing, when ngram drafting found no
        candidate in any slot (the plain tick is cheaper then). A draft
        token is emitted only where it equals the verifier's argmax, and
        rejected writes sit past the committed lengths, where later
        writes overwrite them."""
        s, k = self.max_slots, self.spec_k
        dev = self.device
        # The round moves tokens on the host; the device token vector is
        # stale after it, so the next plain dispatch rebuilds it from
        # the host mirror.
        self._dev_tok = None
        decoding = [sl is not None and not sl["pending"]
                    for sl in self._slots]
        if not any(decoding):
            return False  # a preemption emptied the round
        if self.speculate == "ngram":
            drafts = [[0] * k for _ in range(s)]
            got = False
            for i, sl in enumerate(self._slots):
                if decoding[i]:
                    d = spec.ngram_draft(sl["out"], k)
                    drafts[i][:len(d)] = d
                    got = got or bool(d)
            if not got:
                return False  # no lookup hit anywhere: the plain tick
        t_step = time.monotonic()
        try:
            active = _to_device(decoding, torch.bool, dev)
            last = _to_device(self._last_tok, torch.long, dev)
            if self.speculate == "draft":
                cols, cur = [], last
                for _ in range(k):
                    dlogits, self._draft_cache = decode_step_slots(
                        self._draft_model, self._draft_cache, cur, active,
                        self._draft_cfg, plain=self.plain)
                    cur = dlogits.argmax(dim=-1)
                    cols.append(cur)
                draft_dev = torch.stack(cols, dim=1)
            else:
                draft_dev = _to_device(drafts, torch.long, dev)
            tokens_dev = torch.cat([last[:, None], draft_dev], dim=1)
            logits = self._verify(tokens_dev, active)
            # The round's one read of the device: the verified tokens
            # (the drafts included) and the verifier's argmax.
            tokens, greedy = torch.stack(
                [tokens_dev, logits.argmax(dim=-1)]).cpu().numpy()
        except Exception as e:
            introspection.note_failure(e, "serve/decode_tick")
            log.exception("speculative verify failed")
            self._reset(e)
            return True
        with self._clock.phase("sample"):
            counts, bonus = spec.greedy_verify(greedy, tokens)
            # Draft mode never commits the bonus token: its K/V is not in
            # the draft cache (the drafter stepped k times), so committing
            # it would part the caches; it becomes the next round's last
            # token instead.
            cap = k if self.speculate == "draft" else k + 1
            commit = [0] * s
            emitted: dict = {}
            for i, sl in enumerate(self._slots):
                if not decoding[i]:
                    continue
                a = int(counts[i]) - 1
                seq = [int(t) for t in tokens[i, 1:1 + a]] + [int(bonus[i])]
                c = min(len(seq), cap, sl["remaining"])
                commit[i] = c
                emitted[i] = seq[:c]
                h = trace.handle(sl["rid"])
                if h is not None:
                    h.instant(trace.EV_DISPATCH,
                              {"tick": self.steps_run + 1, "spec": True,
                               "drafted": k, "committed": c}, ts=t_step)
        try:
            self._cache = advance_lengths(
                self._cache, _to_device(commit, torch.int32, dev), active)
            if self.speculate == "draft":
                # The draft cache's prefix matches the main cache's token
                # for token: the length is the whole re-anchor.
                self._draft_cache = dataclasses.replace(
                    self._draft_cache, length=self._cache.length.clone())
        except Exception as e:
            introspection.note_failure(e, "serve/decode_tick")
            log.exception("speculative commit failed")
            self._reset(e)
            return True
        t_tick = time.monotonic() - t_step
        self.steps_run += 1
        self.batches_run = self.steps_run
        self.spec_ticks_run += 1
        self.recorder.observe_decode_step(t_tick)
        self._budget.note_decode(t_tick)
        # The commit is queued, never waited for, and no Event tracks it,
        # so the probe cannot see it: this slice is counted hidden.
        with self._clock.phase("stream", exposed=False):
            n_dec = sum(decoding)
            self.recorder.observe_spec(
                drafted=n_dec * k,
                accepted=int(sum(counts[i] for i in emitted)) - n_dec,
                verifies=n_dec, committed=sum(commit))
            for i, toks in emitted.items():
                sl = self._slots[i]
                h = trace.handle(sl["rid"])
                if h is not None and toks:
                    h.begin(trace.SPAN_STREAM,
                            {"tokens": len(toks), "spec": True})
                for tok in toks:
                    sl["out"].append(tok)
                    sl["len"] = min(sl["len"] + 1, self.max_len)
                    self._last_tok[i] = tok
                    sl["remaining"] -= 1
                    self.recorder.decode_token(sl["rid"])
                    _stream_event(sl["stream"], {"token": tok}, sl["rid"])
                if h is not None and toks:
                    h.end(trace.SPAN_STREAM)
                if sl["remaining"] <= 0:
                    self._finish(i)
        return True

    def _finish(self, i: int):
        sl = self._slots[i]
        self._release_slot(i)
        out = [int(t) for t in sl["out"]]
        if not sl["fut"].done():
            sl["fut"].set_result(out)
        _stream_event(sl["stream"], {"done": True, "tokens": out},
                      sl["rid"])
        self.recorder.finish(sl["rid"])
        self.requests_served += 1
        self._slots[i] = None

    def _reset(self, err):
        """After a device failure: fail every in-flight and backlogged
        request and rebuild the cache from scratch."""
        self._inflight = []
        self._dev_tok = None
        self._tok_overrides = {}
        self.recorder.engine_resets.inc()
        for i, sl in enumerate(self._slots):
            if sl is not None:
                _fail(sl["fut"], sl["stream"], err, sl["rid"],
                      self.recorder)
            self._slots[i] = None
        for item in self._backlog:
            _fail(item[3], item[4], err, item[5], self.recorder)
        self._backlog.clear()
        self._fresh_state()


class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over a paged KV cache: slots share a pool of
    `pool_pages` pages (row 0 is the trash page) instead of each holding
    max_len positions, so the pool can be far smaller than the slots'
    combined capacity.

    Page lifecycle, all on the host between device steps:
      - admit: match the prompt's full pages against the prefix index
        (pages kept from earlier requests, shared by refcount, their
        forward skipped) and allocate fresh pages for the rest; a request
        the pool cannot cover now waits in the backlog, after the prefix
        index has given back what it holds;
      - prefill: the unshared suffix runs in chunks of whole pages;
      - decode: before each tick, slots whose next write (a speculative
        tick's whole verify window) opens a page get one through masked
        assign_pages scatters;
      - exhaustion: with no page free, preempt the youngest request: free
        its pages and requeue it at the front of the backlog (its prompt
        and the tokens so far become its new prompt);
      - finish: pages go back to the free list.

    `max_len` rounds up to a page multiple; the prompt bucket is the
    page.

    KV thermal observability: the allocator stamps every page's touches
    and its tenant (from the request's tags), and once per
    `thermal_interval_s` the loop takes `thermal_census()` (O(pages) on
    the host: hot, warm and cold pages under `thermal_hot_s` and
    `thermal_warm_s`, per-tenant pages, the working set) into the
    recorder, with `kv/thrash` instants for prefix pages re-referenced
    after their eviction; every admitted prompt leaves a
    `kv/prefix_access` instant."""

    def __init__(self, model, cfg, max_slots: int = 8,
                 max_len: int = 2048, page: int = 128,
                 pool_pages: int | None = None,
                 max_prompt_len: int = 1024, prefix_cap: int = 256,
                 prefill_chunk: int = 0, prefill_workers: int = 0,
                 engine_core: str = "async", plain: bool = False,
                 recorder: RequestRecorder | None = None,
                 speculate: str = "off", spec_k: int = 4,
                 draft_layers: int = 2,
                 thermal_hot_s: float = 2.0, thermal_warm_s: float = 10.0,
                 thermal_interval_s: float = 1.0):
        max_len = -(-max_len // page) * page
        self.page = page
        self.max_pages = max_len // page
        # Default pool: half the full reservation, plus the trash row.
        self.pool_pages = pool_pages or max_slots * self.max_pages // 2 + 1
        self.preemptions = 0
        self.prefix_cap = prefix_cap
        self.prefix_pages_reused = 0
        self.thermal_hot_s = thermal_hot_s
        self.thermal_warm_s = thermal_warm_s
        self.thermal_interval_s = thermal_interval_s
        # rid -> (tenant, class), bounded, oldest dropped first
        self._tenants: collections.OrderedDict[int, tuple[str, str]] = \
            collections.OrderedDict()
        self._tenants_cap = 4096
        super().__init__(model, cfg, max_slots=max_slots, max_len=max_len,
                         prompt_bucket=page, max_prompt_len=max_prompt_len,
                         prefill_chunk=prefill_chunk,
                         prefill_workers=prefill_workers,
                         engine_core=engine_core, plain=plain,
                         recorder=recorder, speculate=speculate,
                         spec_k=spec_k, draft_layers=draft_layers)

    def submit(self, tokens, max_new_tokens, temperature, stream=None,
               trace_ctx=None):
        """Reject a prompt whose pages can never all be free at once:
        admission would retry it forever and block every later
        request."""
        pages = -(-len(tokens) // self.page)
        if pages > self.pool_pages - 1:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            self.recorder.validation_failures.inc()
            _fail(fut, stream, ValueError(
                f"prompt needs {pages} pages but the pool has only "
                f"{self.pool_pages - 1} usable; raise --pool-pages"))
            return fut
        return super().submit(tokens, max_new_tokens, temperature,
                              stream=stream, trace_ctx=trace_ctx)

    def recover_after_worker_death(self, err: Exception) -> None:
        # The base rebuilds the pool, the allocator and the prefix index,
        # and publishes the empty pool's gauges and census.
        with self._mu:
            self._tenants.clear()
            super().recover_after_worker_death(err)

    # ---------- hooks ----------

    def _note_tenant(self, rid: int, tags: dict | None) -> None:
        if not tags:
            return
        tenant = tags.get("tenant")
        if tenant is None:
            return
        self._tenants[rid] = (str(tenant), str(tags.get("class", "-")))
        while len(self._tenants) > self._tenants_cap:
            self._tenants.popitem(last=False)

    def thermal_census(self, top_n: int = 16) -> dict:
        """Live thermal snapshot of the page pool (the /debugz?kv=1
        payload): the rows of live slots count hot (the card reads them
        every tick), the prefix index's rows carry the cold-evictable
        linkage. Under `_mu`: the slots and the pool do not move
        mid-census."""
        with self._mu:
            active: set[int] = set()
            for sl in self._slots:
                if sl is not None:
                    active.update(sl["rows"])
            return self._alloc.thermal_census(
                hot_s=self.thermal_hot_s, warm_s=self.thermal_warm_s,
                active_rows=active,
                prefix_rows=self.prefix_index.rows_held(), top_n=top_n)

    def _record_occupancy(self):
        super()._record_occupancy()
        # The prefix cache's pages are spent pool too.
        self.recorder.set_kv_pages(
            used=self._alloc.pages_in_use, total=self._alloc.n_pages - 1)
        self.recorder.set_prefix_cache_pages(self.prefix_index.pages_held())
        # The census is O(pages) on the host: at most once an interval,
        # not once a tick.
        now = time.monotonic()
        if now - self._last_census_ts >= self.thermal_interval_s:
            self._last_census_ts = now
            self.recorder.set_kv_thermal(self.thermal_census())
            self._emit_thrash_events()

    def _emit_thrash_events(self) -> None:
        """One kv/thrash instant per prefix page re-referenced after its
        eviction since the last call, and the running counter track."""
        new = self.prefix_index.rereferences - self._rerefs_seen
        if new <= 0:
            return
        ages = list(self.prefix_index.reref_ages)[-new:]
        self._rerefs_seen = self.prefix_index.rereferences
        if events.enabled():
            for _, age in ages:
                events.instant("kv/thrash", "kv", {"age_s": round(age, 3)})
            events.counter("serve/kv_thrash",
                           {"rerefs": self.prefix_index.rereferences})

    def _fresh_state(self):
        # The old pool goes first, so the card never holds two.
        self._cache = None
        self._cache = init_paged_cache(self.cfg, self.max_slots,
                                       self.pool_pages, self.page,
                                       self.max_pages, self.device)
        self._alloc = PageAllocator(self.pool_pages)
        self.prefix_index = PrefixIndex(self._alloc, cap=self.prefix_cap)
        self._rerefs_seen = 0
        self._last_census_ts = 0.0
        # Requests whose admission waits on free pages: a req/page_stall
        # span stays open from the first failed allocation to the admit.
        self._page_stalled: set = set()
        self._fresh_draft_state()

    @property
    def pages_in_use(self) -> int:
        return self._alloc.pages_in_use

    def _try_alloc(self, n):
        """alloc, evicting prefix-index pages under pressure: they are a
        cache, and preempting live work to keep them would invert the
        priority."""
        rows = self._alloc.alloc(n)
        while rows is None and self.prefix_index.evict_lru():
            rows = self._alloc.alloc(n)
        return rows

    def _free_slot_pages(self, i):
        sl = self._slots[i]
        if sl and sl["rows"]:
            self._alloc.free(sl["rows"])
            sl["rows"] = []

    def _release_slot(self, i):
        self._free_slot_pages(i)

    def _preempt_youngest(self) -> int | None:
        """Free the most recently admitted request's pages and requeue it
        at the front of the backlog, its generated tokens part of its
        next prompt. The slot asking for a page is a valid victim.
        Returns the victim slot, or None if nothing is active."""
        victims = [i for i, sl in enumerate(self._slots) if sl is not None]
        if not victims:
            return None
        i = max(victims, key=lambda j: self._slots[j]["admitted"])
        sl = self._slots[i]
        self._free_slot_pages(i)
        self._backlog.insert(0, (tuple(sl["out"]), sl["remaining"],
                                 sl["temp"], sl["fut"], sl["stream"],
                                 sl["rid"]))
        self._slots[i] = None
        self.preemptions += 1
        self.recorder.preempt(sl["rid"])
        return i

    def _admit_one(self, item, slot_idx) -> bool:
        """False = not enough pages right now (item NOT consumed)."""
        tokens, n_new, temp, fut, stream, rid = item
        page = self.page
        n_pages = -(-len(tokens) // page)
        if n_pages > self.pool_pages - 1:
            # A preempted request's regrown prompt can outgrow the pool
            # that submit() checked: fail it, do not block the backlog.
            self._page_stalled.discard(rid)
            _fail(fut, stream, RuntimeError(
                f"request needs {n_pages} prompt pages but the pool has "
                f"only {self.pool_pages - 1} usable; raise --pool-pages"),
                rid, self.recorder)
            return True  # consumed
        # Share the longest indexed chain of FULL prompt pages; the page
        # holding the last prompt token stays private, since decode
        # writes into it.
        n_full = (len(tokens) - 1) // page
        h = trace.handle(rid)
        if h is not None:
            h.begin(trace.SPAN_PREFIX_LOOKUP, {"full_pages": n_full})
        keys = PrefixIndex.chain_keys(tokens, page, n_full)
        shared = self.prefix_index.match(keys)
        if h is not None:
            h.end(trace.SPAN_PREFIX_LOOKUP, {"shared_pages": len(shared)})
            h.begin(trace.SPAN_PAGE_ALLOC,
                    {"pages": n_pages - len(shared)})
        fresh = self._try_alloc(n_pages - len(shared))
        if fresh is None:
            self._alloc.free(shared)  # drop the refs; entries stay
            if h is not None:
                h.end(trace.SPAN_PAGE_ALLOC, {"ok": False})
                if rid not in self._page_stalled:
                    # Open until the retry that admits it.
                    self._page_stalled.add(rid)
                    h.begin(trace.SPAN_PAGE_STALL,
                            {"pages_needed": n_pages - len(shared)})
            return False
        if h is not None:
            h.end(trace.SPAN_PAGE_ALLOC,
                  {"ok": True, "fresh_pages": len(fresh)})
            if rid in self._page_stalled:
                self._page_stalled.discard(rid)
                h.end(trace.SPAN_PAGE_STALL)
        if n_full:
            # One lookup per admitted prompt with a full page (shorter
            # prompts can never hit; a retried admission counts once).
            self.recorder.prefix_lookup(hit=bool(shared))
        p_len = len(shared) * page
        rows = shared + fresh
        owner = self._tenants.get(rid)
        if owner is not None:
            self._alloc.set_owner(rows, owner[0], owner[1])
        if events.enabled():
            # The prompt's page-chain hashes: a touch trace to replay.
            events.instant("kv/prefix_access", "kv", {
                "rid": rid,
                "tenant": owner[0] if owner else None,
                "class": owner[1] if owner else None,
                "keys": [k for k, _ in keys],
                "hit_pages": len(shared),
                "full_pages": n_full,
            })
        table_row = rows + [0] * (self.max_pages - len(rows))
        self._cache = set_slot_pages(
            self._cache, slot_idx,
            _to_device(table_row, torch.int32, self.device), p_len)
        self._admit_seq += 1
        self._slots[slot_idx] = {
            "fut": fut, "stream": stream, "remaining": n_new,
            "out": list(tokens), "temp": temp,
            "pending": list(tokens[p_len:]), "len": p_len,
            "rows": rows, "keys": keys, "n_shared": len(shared),
            "admitted": self._admit_seq, "rid": rid}
        self._last_tok[slot_idx] = 0
        self._temps[slot_idx] = temp
        self.prefix_pages_reused += len(shared)
        if shared:
            self.recorder.prefix_pages_reused.inc(len(shared))
        return True

    def _run_chunk(self, slot_idx, tokens, start, new_len):
        # The start is length[slot] on the device, set by admission or
        # by the previous chunk.
        last, self._cache = prefill_suffix_paged(
            self.model, self._cache, slot_idx, tokens, new_len, self.cfg,
            plain=self.plain)
        return last

    def _step(self, tokens, active):
        logits, self._cache = decode_step_paged(self.model, self._cache,
                                                tokens, active, self.cfg,
                                                plain=self.plain)
        return logits

    def _on_prefill_complete(self, slot_idx, sl):
        # Keep the freshly computed full pages for later prompts (the
        # shared ones are indexed already).
        for j in range(sl["n_shared"], len(sl["keys"])):
            self.prefix_index.insert(sl["keys"][j], sl["rows"][j])

    def _pre_step(self) -> bool:
        """Give every decoding slot whose coming writes reach unassigned
        pages fresh pages (masked scatters), preempting on exhaustion.
        False = a device error was handled.

        A speculative tick writes positions [len, len + spec_k] before it
        commits, so the growth covers the whole verify window: rounds of
        at most one page a slot, until every decoding slot's window is
        backed (a second round only when the window spans a page
        boundary past a fresh page)."""
        self._spec_tick = self._want_spec_tick()
        lookahead = self.spec_k if self._spec_tick else 0
        while True:
            grew = self._grow_pages_round(lookahead)
            if grew is None:
                return False
            if not grew:
                return True

    def _grow_pages_round(self, lookahead: int) -> bool | None:
        """One masked-scatter round of page growth: each decoding slot
        whose write window [len, len + lookahead] reaches past its pages
        gets ONE page. True if a scatter ran (the caller loops), False
        when nothing was needed, None on a handled device error."""
        s, page = self.max_slots, self.page
        mask, pos, rws = [False] * s, [0] * s, [0] * s
        for i, sl in enumerate(self._slots):
            if sl is None or sl["pending"] or sl["remaining"] <= 0:
                # Prefilling slots hold all their prompt pages; drained
                # slots (final token dispatched, fetch pending) never
                # tick again, so a page for them would leak.
                continue
            # The highest page the window touches, within the capacity.
            target = min((sl["len"] + lookahead) // page,
                         self.max_pages - 1)
            pg = len(sl["rows"])  # next unallocated page index
            if pg > target:
                continue
            row = None
            while row is None and self._slots[i] is not None:
                got = self._try_alloc(1)
                if got is not None:
                    row = got[0]
                    continue
                # Under pressure with a tick outstanding, fetch it before
                # preempting: finishing slots return pages, and a victim
                # must requeue with that tick's token delivered. Slots the
                # fetch finished lose the page this sweep gave them.
                if self._inflight:
                    self._drain_inflight()
                    for j, s2 in enumerate(self._slots):
                        if s2 is None:
                            mask[j] = False
                    continue
                victim = self._preempt_youngest()
                # Slot i itself is always a candidate, so a victim
                # exists. One granted a page earlier in this sweep must
                # not have it written: the row is free again.
                mask[victim] = False
            if self._slots[i] is None:
                continue
            sl["rows"].append(row)
            mask[i], pos[i], rws[i] = True, pg, row
        if not any(mask):
            return False
        dev = self.device
        try:
            self._cache = assign_pages(
                self._cache, _to_device(pos, torch.long, dev),
                _to_device(rws, torch.int32, dev),
                _to_device(mask, torch.bool, dev))
        except Exception as e:
            introspection.note_failure(e, "serve/assign_pages")
            log.exception("assign_pages failed")
            self._reset(e)
            return None
        return True


class EngineSupervisor:
    """Worker-restart loop (serve --supervise): watches the engine's
    worker thread and, when it dies unexpectedly (an uncaught error, an
    injected kill, anything that escapes the guarded regions), runs the
    engine's recovery (every in-flight request fails with an error,
    slots and KV pages are reclaimed, the occupancy gauges zeroed) and
    starts a fresh worker under a bounded exponential backoff:
    consecutive deaths double the delay up to `backoff_cap_s`, a worker
    alive `stable_after_s` resets the ladder, and more than
    `max_restarts` consecutive deaths makes the supervisor give up
    loudly (the engine stays recovered but stopped; /healthz shows
    worker_alive false). Dead prefill-pool workers are replaced on the
    same ladder, gated by a deadline instead of a sleep, and fail no
    request.

    Without it, a dead worker leaves /healthz green, slots occupied and
    every queued future waiting for its client's timeout."""

    def __init__(self, engine, backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 10.0, max_restarts: int = 16,
                 poll_interval_s: float = 0.2,
                 stable_after_s: float = 30.0):
        self.engine = engine
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_restarts = max_restarts
        self.poll_interval_s = poll_interval_s
        self.stable_after_s = stable_after_s
        self.restarts = 0           # lifetime restarts (monotonic)
        self.gave_up = False
        self._consecutive = 0
        self._last_restart: float | None = None
        self.prefill_restarts = 0
        self._prefill_consecutive = 0
        self._prefill_last: float | None = None
        self._prefill_next_ok = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-supervisor")
        self._thread.start()
        log.info("engine supervisor armed: backoff %.2fs..%.1fs, "
                 "max %d consecutive restarts", self.backoff_base_s,
                 self.backoff_cap_s, self.max_restarts)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _delay(self, consecutive: int) -> float:
        return min(self.backoff_cap_s,
                   self.backoff_base_s * 2 ** (consecutive - 1))

    def _supervise_prefill_pool(self, eng, now: float) -> None:
        """Replace dead prefill-pool workers: partial recovery, no
        request fails and no page moves, and the next replacement waits
        on the ladder's deadline, never delaying decode supervision."""
        restart = getattr(eng, "restart_dead_prefill_workers", None)
        if restart is None or now < self._prefill_next_ok:
            return
        if (self._prefill_last is not None
                and now - self._prefill_last >= self.stable_after_s):
            self._prefill_consecutive = 0  # the pool had stabilized
        n = restart()
        if not n:
            return
        self._prefill_consecutive += 1
        self._prefill_last = now
        delay = self._delay(self._prefill_consecutive)
        self._prefill_next_ok = now + delay
        self.prefill_restarts += n
        eng.recorder.prefill_worker_restarts.inc(n)
        log.warning("prefill-pool worker death: %d worker(s) replaced "
                    "(decode unaffected; next replacement gated for "
                    "%.2fs)", n, delay)
        if events.enabled():
            events.instant("supervisor/prefill_worker_death", "chaos",
                           {"workers": n})
            events.instant("supervisor/prefill_worker_restart", "chaos",
                           {"restarts": self.prefill_restarts,
                            "backoff_s": round(delay, 3)})

    def _loop(self):
        eng = self.engine
        while not self._stop.is_set():
            if eng._stop.is_set():
                return  # a deliberate engine.stop(): nothing to revive
            self._supervise_prefill_pool(eng, time.monotonic())
            if eng.thread.is_alive():
                self._stop.wait(self.poll_interval_s)
                continue
            now = time.monotonic()
            if (self._last_restart is not None
                    and now - self._last_restart >= self.stable_after_s):
                self._consecutive = 0  # the worker had stabilized
            self._consecutive += 1
            err = RuntimeError(
                "engine worker died unexpectedly; request failed during "
                f"supervised recovery (restart {self.restarts + 1})")
            log.error("engine worker died; recovering "
                      "(consecutive death %d)", self._consecutive)
            if events.enabled():
                events.instant("supervisor/worker_death", "chaos",
                               {"consecutive": self._consecutive})
            try:
                eng.recover_after_worker_death(err)
            except Exception:
                log.exception("engine recovery failed; restarting anyway")
            if self._consecutive > self.max_restarts:
                self.gave_up = True
                log.error("engine worker died %d consecutive times; "
                          "supervisor giving up (engine recovered but "
                          "stopped: restart the server)",
                          self._consecutive)
                if events.enabled():
                    events.instant("supervisor/gave_up", "chaos",
                                   {"restarts": self.restarts})
                return
            delay = self._delay(self._consecutive)
            if self._stop.wait(delay) or eng._stop.is_set():
                return
            eng._start_worker()
            self.restarts += 1
            eng.worker_restarts = self.restarts
            self._last_restart = time.monotonic()
            eng.recorder.worker_restarts.inc()
            log.warning("engine worker restarted (restart %d, after "
                        "%.2fs backoff)", self.restarts, delay)
            if events.enabled():
                events.instant("supervisor/worker_restart", "chaos",
                               {"restart": self.restarts,
                                "backoff_s": round(delay, 3)})


def engine_state_snapshot(engine, recorder, replica_id: str,
                          engine_kind: str, fabric_mon=None) -> dict:
    """/debugz?state=1: the fleet scraper's machine-readable snapshot,
    the recorder's state_snapshot() plus the engine's liveness and
    counters, with the JAX package's keys, and the fabric block while a
    fabric health monitor runs (absent otherwise: the fleet scraper's
    mixed-version contract)."""
    snap = recorder.state_snapshot()
    alive_fn = getattr(engine, "prefill_workers_alive", None)
    snap.update({
        "replica_id": replica_id,
        "pid": os.getpid(),
        "engine": engine_kind,
        "worker_alive": engine.thread.is_alive(),
        "worker_restarts": engine.worker_restarts,
        "requests_served": engine.requests_served,
        "batches_run": engine.batches_run,
        "prefill_workers": getattr(engine, "prefill_workers", 0),
        "prefill_workers_alive": alive_fn() if alive_fn else 0,
    })
    if fabric_mon is not None:
        snap["fabric"] = fabric_mon.snapshot()
    return snap


def make_server(engine, port: int,
                replica_id: str | None = None) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                alive_fn = getattr(engine, "prefill_workers_alive", None)
                return self._send({
                    "ok": True,
                    "replica_id": replica_id,
                    "batches": engine.batches_run,
                    "requests": engine.requests_served,
                    # A dead worker behind a green /healthz is the wedge
                    # the supervisor exists for: report it either way,
                    # and the prefill pool's too.
                    "worker_alive": engine.thread.is_alive(),
                    "worker_restarts": engine.worker_restarts,
                    "prefill_workers": getattr(engine, "prefill_workers",
                                               0),
                    "prefill_workers_alive": (alive_fn() if alive_fn
                                              else 0),
                    "prefill_worker_restarts": getattr(
                        engine, "prefill_worker_restarts", 0)})
            return self._send({"error": "not found"}, 404)

        def _stream_response(self, stream_q):
            """Server-Sent Events, one data line per engine event."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            # An idle timeout, not a deadline: only a 120 s gap between
            # events means the engine is stuck.
            while True:
                try:
                    ev = stream_q.get(timeout=120)
                except queue.Empty:
                    ev = {"error": "stream idle timeout"}
                self.wfile.write(
                    b"data: " + json.dumps(ev).encode() + b"\n\n")
                self.wfile.flush()
                if "done" in ev or "error" in ev:
                    return

        def do_POST(self):
            if self.path != "/generate":
                return self._send({"error": "not found"}, 404)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                args = ([int(t) for t in req["tokens"]],
                        int(req.get("max_new_tokens", 16)),
                        float(req.get("temperature", 0.0)))
                # `"trace": true` forces the request into the trace
                # sample; `"tags"` stamp its spans (loadgen sends the
                # tenant and request class).
                trace_ctx = None
                if req.get("trace") or req.get("tags"):
                    tags = req.get("tags")
                    trace_ctx = {
                        "force": bool(req.get("trace")),
                        "tags": tags if isinstance(tags, dict) else None}
                if req.get("stream"):
                    stream_q: queue.Queue = queue.Queue()
                    engine.submit(*args, stream=stream_q,
                                  trace_ctx=trace_ctx)
                    return self._stream_response(stream_q)
                fut = engine.submit(*args, trace_ctx=trace_ctx)
                return self._send({"tokens": fut.result(timeout=120)})
            except (KeyError, ValueError, TypeError) as e:
                return self._send({"error": str(e)}, 400)
            except Exception as e:
                return self._send({"error": str(e)}, 500)

    return ThreadingHTTPServer(("", port), Handler)


def expect_serving_plan(args, cfg, engine, device) -> dict | None:
    """Record the utils/hbm_plan budget of this launch
    (introspection.set_expected_hbm): the continuous engine's full slots
    x max_len reservation, or the paged pool's share of it, at the
    card's capacity. None, and nothing recorded, off the card (a plan
    needs a capacity)."""
    from container_engine_accelerators_tpu_torch.utils.hbm_plan import (
        plan_serving,
    )
    if device.type != "cuda":
        log.info("no hbm_plan expectation off the card")
        return None
    if args.engine == "paged":
        frac = (args.pool_pages / (args.max_batch * max(engine.max_pages, 1))
                if args.pool_pages else 0.5)
    else:
        frac = 1.0  # full slots x max_len reservation
    plan = plan_serving(cfg, tp=1, max_slots=args.max_batch,
                        max_len=args.max_len, pool_fraction=frac,
                        kv_dtype=args.kv_dtype,
                        weight_dtype=args.weight_dtype, device=device)
    introspection.set_expected_hbm(plan)
    return plan


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="a training checkpoint dir (training/"
                        "checkpoint.py) or an HF Llama export")
    p.add_argument("--tiny", action="store_true",
                   help="random llama_tiny instead of --checkpoint")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="window engine: requests per batch; continuous/"
                        "paged engine: decode slots")
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--engine", choices=("window", "continuous", "paged"),
                   default="window",
                   help="window = shape-bucket batch-window engine "
                        "(streams its tokens only when the batch "
                        "completes; for real time-to-first-token "
                        "streaming use continuous or paged); "
                        "continuous = in-flight batching over a fixed "
                        "slot pool (admits new requests into the "
                        "running decode batch); paged = continuous "
                        "batching over a shared KV page pool (slots "
                        "hold only the pages they filled; preemption "
                        "on pool exhaustion)")
    p.add_argument("--max-len", type=int, default=2048,
                   help="continuous/paged engine: logical KV capacity "
                        "per slot")
    p.add_argument("--page-size", type=int, default=128,
                   help="paged engine: tokens per KV page (the CUDA "
                        "kernel takes any size)")
    p.add_argument("--pool-pages", type=int, default=None,
                   help="paged engine: total pool pages incl. the "
                        "reserved trash row (default: half the full "
                        "slots x max_len reservation)")
    p.add_argument("--prefix-cache-cap", type=int, default=256,
                   help="paged engine: max retained full prompt pages "
                        "in the prefix cache (0 disables sharing)")
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="continuous/paged engine: max prompt tokens "
                        "prefilled between decode steps (bounds the "
                        "latency a long admission injects into "
                        "in-flight requests); 0 = whole prompt at once")
    p.add_argument("--prefill-workers", type=int, default=0,
                   help="continuous/paged engine: split into a decode "
                        "loop and this many prefill-pool threads. The "
                        "decode thread keeps the tick cadence and "
                        "admission; prefill chunks run on the pool under "
                        "a token budget (one chunk costs about half a "
                        "decode tick while anything decodes), all on the "
                        "card's one stream. 0 (the default) keeps the "
                        "single loop. --supervise also watches the pool: "
                        "a dead prefill worker is replaced without "
                        "failing any request")
    p.add_argument("--speculate", choices=("off", "ngram", "draft"),
                   default="off",
                   help="speculative decoding for greedy requests: draft "
                        "--spec-k tokens (ngram = prompt lookup, no "
                        "weights; draft = the model's first "
                        "--draft-layers layers), score them in ONE verify "
                        "pass, emit the accepted prefix plus the "
                        "verifier's own next token. The tokens are those "
                        "of off up to the last bits of the logits; only "
                        "the tokens per pass change. Ticks with a "
                        "sampled (temperature > 0) slot run the plain "
                        "step")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per verify pass (--speculate)")
    p.add_argument("--draft-layers", type=int, default=2,
                   help="--speculate draft: layers in the truncated "
                        "self-draft model")
    p.add_argument("--supervise", action="store_true",
                   help="arm the EngineSupervisor: a dead engine worker "
                        "thread is recovered (in-flight requests fail "
                        "with errors, slots and KV pages reclaimed, "
                        "occupancy gauges zeroed) and restarted under a "
                        "bounded exponential backoff instead of wedging "
                        "the server")
    p.add_argument("--supervise-backoff", type=float, default=0.5,
                   help="supervisor restart backoff base seconds "
                        "(doubles per consecutive death, capped at 10 s; "
                        "a worker stable for 30 s resets the ladder)")
    p.add_argument("--supervise-max-restarts", type=int, default=16,
                   help="consecutive worker deaths after which the "
                        "supervisor gives up loudly (the engine stays "
                        "recovered but stopped)")
    p.add_argument("--quantize-int8", action="store_true",
                   help="deprecated alias for --weight-dtype int8")
    p.add_argument("--weight-dtype", choices=("bf16", "int8"),
                   default="bf16",
                   help="int8: per-output-channel int8 weight storage, "
                        "dequantized inside the matmul kernel")
    p.add_argument("--kv-dtype", choices=("bf16", "int8", "int4"),
                   default="bf16",
                   help="KV-cache storage for every engine: int8 keeps K/V "
                        "as int8 with one f32 scale per (token, KV head), "
                        "dequantized inside the attention kernels (about "
                        "half the bytes of bf16 a token); int4 packs two "
                        "4-bit values a byte (about a quarter; lossier). "
                        "Independent of --weight-dtype")
    p.add_argument("--thermal-hot-s", type=float, default=2.0,
                   help="paged engine: pages idle <= this many seconds "
                        "count hot in the KV thermal census")
    p.add_argument("--thermal-warm-s", type=float, default=10.0,
                   help="paged engine: pages idle <= this (and > "
                        "--thermal-hot-s) count warm; beyond is cold")
    p.add_argument("--thermal-interval-s", type=float, default=1.0,
                   help="paged engine: seconds between KV thermal "
                        "census snapshots (O(pages) host work each)")
    p.add_argument("--replica-id", default=None,
                   help="fleet replica identity: stamped into the "
                        "EventBus anchor and process track name, every "
                        "request trace span, the serve_replica_info "
                        "metric and /healthz, so N replicas' dumps merge "
                        "into distinct per-replica timeline tracks. "
                        "Default: the TPU_REPLICA_ID env var, else "
                        "pid-<pid>")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve request-lifecycle Prometheus metrics "
                        "(TTFT/TPOT/queue-wait histograms, slot and KV "
                        "page occupancy, host phases) and /debugz on "
                        "this port; 0 binds an ephemeral port (logged "
                        "at startup); omit to disable the exporter")
    p.add_argument("--metrics-host", default="",
                   help="bind host for the metrics exporter (default: "
                        "all interfaces)")
    p.add_argument("--trace-dump", default=None,
                   help="enable the flight-recorder EventBus and write "
                        "its ring as Chrome-trace JSON to this path on "
                        "exit/crash and on SIGUSR2 (a directory gets a "
                        "per-pid file); TPU_TRACE_DUMP env is the "
                        "flagless equivalent")
    p.add_argument("--trace-jsonl", default=None,
                   help="stream the EventBus to this JSONL file as "
                        "events happen (a directory gets a per-pid "
                        "file), the per-process input `trace merge` "
                        "reads; enables the bus if no --trace-dump "
                        "armed it")
    p.add_argument("--trace-sample-rate", type=float,
                   default=trace.DEFAULT_SAMPLE_RATE,
                   help="fraction of requests emitting per-request "
                        "spans (req/queue, req/prefill_chunk, "
                        "req/dispatch ... on eid=request id; "
                        "metrics/trace.py), decided per request id. "
                        "Failed/preempted/SLO-violating requests are "
                        "always captured by tail sampling; 0 disables "
                        "head sampling, 1 traces everything")
    p.add_argument("--engine-core", choices=("async", "sync"),
                   default="async",
                   help="async = dispatch batch (window) or tick "
                        "(continuous/paged) t+1 while t runs on the "
                        "device and fetch one behind; sync = fetch each "
                        "at once (the token-identity reference)")
    p.add_argument("--doctor", action="store_true",
                   help="run the streaming doctor (metrics/doctor.py): "
                        "detectors over the flight recorder and the "
                        "request recorder emit deduplicated incident "
                        "bundles (engine hang, OOM precursor, queue "
                        "collapse, SLO burn ...), doctor/<class> "
                        "timeline instants, and "
                        "tpu_doctor_incidents_total / tpu_slo_burn_rate "
                        "on the metrics port; /debugz?doctor=1 serves "
                        "live verdicts. Enables the EventBus if no "
                        "--trace-dump armed it")
    p.add_argument("--doctor-dir", default=None,
                   help="directory for doctor incident bundles "
                        "(default: TPU_DOCTOR_DIR env, else next to the "
                        "trace dump, else the cwd)")
    p.add_argument("--fault-listen", default=None,
                   help="CHAOS/TEST ONLY: tail this JSONL fault-command "
                        "file (written by `inject_fault --kind ... "
                        "--fault-log`) and inject the faults into this "
                        "process: engine hangs and worker deaths, "
                        "fabricated HBM/queue telemetry, health-checker "
                        "storms")
    p.add_argument("--fabric-health", action="store_true",
                   help="run a FabricHealthMonitor in-process "
                        "(metrics/fabric_health.py) over this process's "
                        "group (one NCCL rank on the card, gloo with "
                        "--device cpu): scheduled low-rate collective "
                        "probe sweeps, learned busBW baselines, fabric_"
                        "degraded verdicts and slow-rank localization, "
                        "gauges co-served on --metrics-port and a fabric "
                        "block on /debugz?state=1")
    p.add_argument("--fabric-health-interval", type=float, default=30.0,
                   help="seconds between probe sweeps")
    p.add_argument("--fabric-health-baseline", default=None,
                   help="FABRIC_BASELINE.json to seed the busBW "
                        "baselines from (and re-save on shutdown)")
    p.add_argument("--fabric-health-history", default=None,
                   help="append probe-history JSONL rows here "
                        "(tools/fabric_report.py input)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (args.tiny or args.checkpoint):
        p.error("pass --checkpoint DIR or --tiny")
    logging.basicConfig(level=logging.INFO)
    replica_id = (args.replica_id or os.environ.get("TPU_REPLICA_ID")
                  or f"pid-{os.getpid()}")
    if args.trace_dump:
        events.enable(dump_path=args.trace_dump, signals=True,
                      process_name="serve")
        log.info("flight recorder on; trace dump -> %s (SIGUSR2 dumps "
                 "on demand)", args.trace_dump)
    else:
        events.configure_from_env(process_name="serve")
    # After enable(): enable re-anchors the bus, and the replica stamp
    # must land on the anchor it leaves.
    events.set_replica_id(replica_id)
    if args.trace_jsonl:
        events.stream_jsonl(args.trace_jsonl)
        log.info("streaming EventBus JSONL -> %s", args.trace_jsonl)
    # Always configured: with the bus off, start() returns None and the
    # request path stays span-free; arming the bus later (--doctor)
    # picks the sample rate up as it is.
    trace.configure(sample_rate=args.trace_sample_rate,
                    base_tags={"replica": replica_id})

    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    model, cfg = load_model(None if args.tiny else args.checkpoint,
                            device=args.device)
    if args.kv_dtype != "bf16":
        # One cfg field carries the mode to every engine's cache
        # allocation (init_cache, init_slot_cache, init_paged_cache).
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
        log.info("serving an %s KV cache", args.kv_dtype)
    if args.quantize_int8:  # the deprecated alias
        args.weight_dtype = "int8"
    if args.weight_dtype == "int8":
        if cfg.n_experts:
            p.error("--weight-dtype int8 is not supported for MoE "
                    "models (expert weights have no int8 decode path "
                    "yet)")
        model = quantize_llama_params(model)
        log.info("serving int8-quantized weights")
    if args.speculate != "off":
        if args.spec_k < 1:
            p.error("--spec-k must be >= 1")
        log.info("speculative decoding on: %s drafting, k=%d",
                 args.speculate, args.spec_k)
    spec_kw = dict(speculate=args.speculate, spec_k=args.spec_k,
                   draft_layers=args.draft_layers,
                   engine_core=args.engine_core)
    recorder = RequestRecorder()
    # Replica identity on the scrape surface as an info-style gauge: ONE
    # labeled family carrying the id, rather than a replica label on
    # every serve_* family, so unlabeled-scrape consumers keep working
    # and the fleet exporter owns the per-replica label space.
    from prometheus_client import Gauge
    Gauge("serve_replica_info",
          "Constant 1; the replica_id label names this replica",
          ["replica_id"],
          registry=recorder.registry).labels(replica_id).set(1)
    if args.engine == "paged":
        engine = PagedContinuousEngine(
            model, cfg, max_slots=args.max_batch, max_len=args.max_len,
            page=args.page_size, pool_pages=args.pool_pages,
            prefix_cap=args.prefix_cache_cap,
            prefill_chunk=args.prefill_chunk,
            prefill_workers=args.prefill_workers, recorder=recorder,
            thermal_hot_s=args.thermal_hot_s,
            thermal_warm_s=args.thermal_warm_s,
            thermal_interval_s=args.thermal_interval_s, **spec_kw)
    elif args.engine == "continuous":
        engine = ContinuousEngine(
            model, cfg, max_slots=args.max_batch, max_len=args.max_len,
            prefill_chunk=args.prefill_chunk,
            prefill_workers=args.prefill_workers, recorder=recorder,
            **spec_kw)
    else:
        engine = BatchingEngine(model, cfg, max_batch=args.max_batch,
                                window_ms=args.batch_window_ms,
                                recorder=recorder, **spec_kw)
    if args.engine in ("continuous", "paged"):
        expect_serving_plan(args, cfg, engine, model.device)
    doc = None
    if args.doctor:
        from container_engine_accelerators_tpu_torch.metrics import doctor
        if not events.enabled():
            # The detectors read the flight recorder; --doctor without a
            # dump path still needs the ring live.
            events.enable(process_name="serve")
        doc = doctor.Doctor(
            registry=recorder.registry, request_recorder=recorder,
            out_dir=args.doctor_dir if args.doctor_dir else "auto")
        doc.start()
        doctor.set_active(doc)
    sup = None
    if args.supervise:
        sup = EngineSupervisor(
            engine, backoff_base_s=args.supervise_backoff,
            max_restarts=args.supervise_max_restarts)
        sup.start()
    listener = None
    if args.fault_listen:
        from container_engine_accelerators_tpu_torch.metrics.doctor import (
            FaultListener,
        )
        listener = FaultListener(args.fault_listen, engine=engine)
        listener.start()
    fabric_mon = None
    if args.fabric_health:
        from container_engine_accelerators_tpu_torch.metrics import (
            fabric_health,
        )
        # The process's own group: one rank on the serving card (NCCL),
        # or gloo for --device cpu. Gauges co-serve on the request
        # metrics registry; only the sweep thread is started here. A
        # sweep holds the engine's lock (continuous and paged engines),
        # so no tick shares the card with a probe (the engine pauses ~2
        # ms a sweep); on the card a probe copies 64 MiB ten times, ~0.5
        # ms, well above its timing events' resolution.
        cuda = model.device.type == "cuda"
        fabric_mon = fabric_health.FabricHealthMonitor(
            interval=args.fabric_health_interval,
            size_bytes=(1 << 26) if cuda else (1 << 14),
            warmup=1, iters=10 if cuda else 2,
            baseline_path=args.fabric_health_baseline,
            history_path=args.fabric_health_history,
            registry=recorder.registry,
            backend="nccl" if cuda else "gloo", device=model.device,
            sweep_lock=getattr(engine, "_mu", None))
        fabric_mon.start_poll_only()
        fabric_health.set_active(fabric_mon)
        log.info("fabric health monitor on (sweep every %.1fs)",
                 args.fabric_health_interval)
    exporter = None
    if args.metrics_port is not None:
        # The poller reads the serving card only, and none for --device
        # cpu (reading one would create a CUDA context there).
        dev = model.device
        poller = introspection.HbmPoller(
            registry=recorder.registry,
            devices=[] if dev.type == "cpu" else [dev.index or 0])
        exporter = ServeMetricsExporter(recorder, port=args.metrics_port,
                                        host=args.metrics_host,
                                        hbm_poller=poller)
        exporter.state_provider = functools.partial(
            engine_state_snapshot, engine, recorder, replica_id,
            args.engine, fabric_mon=fabric_mon)
        if args.engine == "paged":
            exporter.kv_provider = engine.thermal_census
        exporter.start_background()
        log.info("request metrics on :%d/metrics", exporter.bound_port)
    server = make_server(engine, args.port, replica_id=replica_id)
    log.info("serving on :%d (/generate, /healthz) on %s, %s engine",
             server.server_address[1], model.device, args.engine)
    try:
        # TPU_PROFILE_DIR set: the whole serving session is one
        # torch.profiler capture whose serve/* regions line up with the
        # request metrics; unset: no capture.
        with maybe_profile():
            server.serve_forever()
    finally:
        if fabric_mon is not None:
            fabric_mon.stop()
        if listener is not None:
            listener.stop()
        if doc is not None:
            doc.stop()
        if sup is not None:
            sup.stop()
        engine.stop()
        if exporter is not None:
            exporter.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
