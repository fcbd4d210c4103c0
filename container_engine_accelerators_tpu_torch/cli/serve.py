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

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back. The request recorder, tracing,
speculation, prefill pools and the supervisor come with later slices;
the engines keep the counters that /healthz reports as attributes.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import itertools
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

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


def _fail(fut, stream, exc: Exception, rid=None) -> None:
    if not fut.done():
        fut.set_exception(exc)
    _stream_event(stream, {"error": str(exc)}, rid)


def _to_device(values: list, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Host values as a tensor on `device`. On the card the copy goes
    through pinned memory without blocking, so it does not wait for the
    work still queued there (a copy from pageable memory would)."""
    host = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _validate_request(tokens, max_new_tokens, max_prompt_len, vocab_size,
                      fut, stream, rid=None) -> bool:
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
    _fail(fut, stream, err, rid)
    return False


class BatchingEngine:
    def __init__(self, model, cfg, max_batch: int = 8,
                 window_ms: float = 5.0, max_prompt_len: int = 1024,
                 engine_core: str = "async"):
        if engine_core not in ("async", "sync"):
            raise ValueError(f"engine_core must be 'async' or 'sync', "
                             f"got {engine_core!r}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.max_prompt_len = max_prompt_len
        self._rid = itertools.count(1)  # request ids (count() is atomic)
        # queue.Queue, not SimpleQueue: the C _queue module's timed get
        # can lose a put's wakeup; _work bounds any residual wait
        # (submit sets it AFTER put).
        self.queue: queue.Queue = queue.Queue()
        self._work = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self.worker_restarts = 0
        # "async" dispatches batch t+1's generate() while batch t still
        # runs on the device and fetches batch t one batch behind;
        # "sync" fetches at once (the token-identity reference path).
        self.engine_core = engine_core
        # In-flight state lives on the engine, not in worker locals.
        self._pending: collections.deque = collections.deque()
        self._batch: list = []
        # Dispatched-but-unfetched batches: {"batch", "out", "done"}.
        self._inflight: list = []
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True,
                                       name="serve-batcher")
        self.thread.start()

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float, stream: queue.Queue | None = None
               ) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        rid = next(self._rid)
        if not _validate_request(tokens, max_new_tokens,
                                 self.max_prompt_len, self.cfg.vocab_size,
                                 fut, stream, rid=rid):
            return fut
        self.queue.put((tuple(tokens), max_new_tokens, temperature, fut,
                        stream, rid))
        self._work.set()  # after put: the worker's drain must see it
        return fut

    def stop(self):
        self._stop.set()
        self._work.set()  # wake an idle worker so it can exit promptly

    # ---------- worker ----------

    @staticmethod
    def _bucket_key(item):
        tokens, n_new, temp = item[0], item[1], item[2]
        # One batch decodes with a single temperature.
        return (len(tokens), n_new, temp)

    def _worker(self):
        from container_engine_accelerators_tpu_torch.models.decode import (
            generate,
        )

        pending = self._pending
        while not self._stop.is_set():
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
                        self._drain_batches()
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

            n_new, temp = batch[0][1], batch[0][2]
            try:
                tokens = _to_device([list(item[0]) for item in batch],
                                    torch.long, self.device)
                gen = None
                if temp > 0:
                    gen = torch.Generator(device=self.device).manual_seed(
                        time.time_ns() & 0xFFFF)
                # Dispatch only: generate() never waits for the device.
                out = generate(self.model, tokens, self.cfg, n_new,
                               temperature=temp, generator=gen)
                done = None
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            except Exception as e:
                log.exception("batch failed")
                for item in batch:
                    _fail(item[3], item[4], e, item[5])
                self._batch = []
                continue
            self._inflight.append({"batch": batch, "out": out,
                                   "done": done})
            self._batch = []
            self._drain_batches(keep=1 if self.engine_core == "async"
                                else 0)

    def _device_busy(self) -> bool:
        """True while the newest dispatched-but-unfetched batch still
        runs on the device. Non-blocking: an Event query."""
        if not self._inflight:
            return False
        done = self._inflight[-1]["done"]
        return done is not None and not done.query()

    def _drain_batches(self, keep: int = 0) -> None:
        """Fetch outstanding batches until at most `keep` remain."""
        while len(self._inflight) > keep:
            self._fetch_batch()

    def _fetch_batch(self) -> None:
        """Bring the OLDEST dispatched batch to the host (the engine's
        only wait on the device) and deliver its results and streams."""
        fl = self._inflight.pop(0)
        batch = fl["batch"]
        try:
            out_host = fl["out"].tolist()
        except Exception as e:
            # Device errors of an asynchronous dispatch surface here.
            log.exception("batch failed")
            for item in batch:
                _fail(item[3], item[4], e, item[5])
            return
        for item, row in zip(batch, out_host):
            rid = item[5]
            item[3].set_result(row)
            if item[4] is not None:
                for tok in row[len(item[0]):]:
                    _stream_event(item[4], {"token": tok}, rid)
                _stream_event(item[4], {"done": True, "tokens": row}, rid)
        self.batches_run += 1
        self.requests_served += len(batch)


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
    `_fetch_tick`.

    PagedContinuousEngine overrides the policy hooks (admission, page
    growth, preemption, release); the control flow lives here.
    `plain=True` runs the kernels' plain versions on any device (the
    on-card reference for the kernel path)."""

    def __init__(self, model, cfg, max_slots: int = 8,
                 max_len: int = 2048, prompt_bucket: int = 64,
                 max_prompt_len: int = 1024, prefill_chunk: int = 0,
                 engine_core: str = "async", plain: bool = False):
        if engine_core not in ("async", "sync"):
            raise ValueError(f"engine_core must be 'async' or 'sync', "
                             f"got {engine_core!r}")
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
        self.engine_core = engine_core
        self.plain = plain
        self._rid = itertools.count(1)
        # Dispatched-but-unfetched decode ticks, oldest first:
        # {"toks", "slots": [(slot, final)], "done": CUDA event or None}.
        self._inflight: list = []
        # Device-resident last-token vector (async core) and the
        # host-known tokens to merge into it at the next dispatch.
        self._dev_tok = None
        self._tok_overrides: dict = {}
        # queue.Queue + Event wake, as in BatchingEngine.
        self.queue: queue.Queue = queue.Queue()
        self._work = threading.Event()
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
        self.thread = threading.Thread(target=self._worker, daemon=True,
                                       name="serve-continuous")
        self.thread.start()

    def submit(self, tokens: list[int], max_new_tokens: int,
               temperature: float, stream: queue.Queue | None = None
               ) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        rid = next(self._rid)
        if not _validate_request(tokens, max_new_tokens,
                                 self.max_prompt_len, self.cfg.vocab_size,
                                 fut, stream, rid=rid):
            return fut
        # The prompt is padded up to a bucket multiple before prefill,
        # so the bucketed length must fit the cache too.
        bucketed = -(-len(tokens) // self.prompt_bucket) * self.prompt_bucket
        if (len(tokens) + max_new_tokens > self.max_len
                or bucketed > self.max_len):
            _fail(fut, stream, ValueError(
                f"prompt (bucketed to {bucketed}) + max_new_tokens "
                f"exceeds cache max_len {self.max_len}"), rid)
            return fut
        self.queue.put((tuple(tokens), max_new_tokens, temperature, fut,
                        stream, rid))
        self._work.set()  # after put: the worker's drain must see it
        return fut

    def stop(self):
        self._stop.set()
        self._work.set()

    # ---------- hooks (overridden by the paged engine) ----------

    def _fresh_state(self):
        from container_engine_accelerators_tpu_torch.models.decode import (
            init_slot_cache,
        )

        self._cache = init_slot_cache(self.cfg, self.max_slots,
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
        from container_engine_accelerators_tpu_torch.models.decode import (
            prefill_suffix_slot,
        )

        last, self._cache = prefill_suffix_slot(
            self.model, self._cache, slot_idx, tokens, start, new_len,
            self.cfg, plain=self.plain)
        return last

    def _step(self, tokens: torch.Tensor, active: torch.Tensor
              ) -> torch.Tensor:
        from container_engine_accelerators_tpu_torch.models.decode import (
            decode_step_slots,
        )

        logits, self._cache = decode_step_slots(self.model, self._cache,
                                                tokens, active, self.cfg,
                                                plain=self.plain)
        return logits

    def _on_prefill_complete(self, slot_idx: int, sl: dict) -> None:
        pass

    def _pre_step(self) -> bool:
        """Between the prefill and decode ticks (paged: page growth).
        False = a device error was handled; skip the decode tick."""
        return True

    def _release_slot(self, slot_idx: int) -> None:
        pass

    # ---------- worker ----------

    def _worker(self):
        self._slots: list[dict | None] = [None] * self.max_slots
        self._backlog: list = []
        self._last_tok = [0] * self.max_slots
        self._temps = [0.0] * self.max_slots
        self._admit_seq = 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._fresh_state()
        while not self._stop.is_set():
            self._pump_queue()
            self._admit_phase()
            if all(sl is None for sl in self._slots):
                continue
            self._prefill_tick()
            if self._pre_step():
                self._decode_tick()

    def _pump_queue(self):
        # No timed queue-get: drain without blocking and park on an
        # Event that submit() sets after its put.
        if all(sl is None for sl in self._slots) and not self._backlog:
            self._work.wait(0.05)
        self._work.clear()
        while True:
            try:
                self._backlog.append(self.queue.get_nowait())
            except queue.Empty:
                return

    def _admit_phase(self):
        free = [i for i in range(self.max_slots) if self._slots[i] is None]
        while self._backlog and free:
            item = self._backlog[0]
            try:
                if not self._admit_one(item, free[0]):
                    return  # resources exhausted: retry next loop
            except Exception as e:
                log.exception("admission failed")
                self._backlog.pop(0)
                _fail(item[3], item[4], e, item[5])
                self._reset(e)
                return
            self._backlog.pop(0)
            if self._slots[free[0]] is not None:  # actually admitted
                free.pop(0)

    def _prefill_tick(self) -> bool:
        """Run ONE prompt chunk of the oldest still-prefilling slot; on
        the final chunk, sample the request's first token and move the
        slot to decoding. True iff a chunk ran."""
        from container_engine_accelerators_tpu_torch.models.decode import (
            pick_tokens,
        )

        cand = [i for i, sl in enumerate(self._slots)
                if sl is not None and sl["pending"]]
        if not cand:
            return False
        i = min(cand, key=lambda j: self._slots[j]["admitted"])
        sl = self._slots[i]
        take = len(sl["pending"])
        if self.prefill_chunk:
            take = min(self.prefill_chunk, take)
        final = take == len(sl["pending"])
        bucketed = -(-take // self.prompt_bucket) * self.prompt_bucket
        padded = sl["pending"][:take] + [0] * (bucketed - take)
        start, new_len = sl["len"], sl["len"] + take
        try:
            last_logits = self._run_chunk(
                i, _to_device(padded, torch.long, self.device), start,
                new_len)
            if final:
                temps = _to_device([sl["temp"]], torch.float32, self.device)
                # The first token is read at once (it streams the time to
                # first token); it joins the device token vector through
                # merge_tokens at the next dispatch.
                tok = int(pick_tokens(last_logits[None, :], temps,
                                      self._gen)[0])
        except Exception as e:
            log.exception("prefill chunk failed")
            self._reset(e)
            return False
        sl["pending"] = sl["pending"][take:]
        sl["len"] = new_len
        self.prefill_chunks_run += 1
        self.prefill_tokens_run += take
        self.prefill_chunk_trace.append(self.steps_run)
        if not final:
            return True
        self._on_prefill_complete(i, sl)
        self.prefills_run += 1
        sl["out"].append(tok)
        sl["remaining"] -= 1
        self._last_tok[i] = tok
        self._tok_overrides[i] = tok
        _stream_event(sl["stream"], {"token": tok}, sl["rid"])
        if sl["remaining"] <= 0:
            self._finish(i)
        return True

    def _decode_tick(self) -> bool:
        """Dispatch one decode step over every decoding slot (prefilling
        slots stay inactive). Counts (lengths, remaining budgets) move at
        dispatch, so the next iteration's masks and page growth see the
        state after the tick; the token values land in `_fetch_tick`,
        one tick later on the async core, at once on the sync core.
        True iff a tick was dispatched or an outstanding one fetched."""
        from container_engine_accelerators_tpu_torch.models.decode import (
            merge_tokens,
            pick_tokens,
        )

        decoding = [sl is not None and not sl["pending"]
                    and sl["remaining"] > 0 for sl in self._slots]
        if not any(decoding):
            # Nothing to dispatch: land what is still in flight (slots
            # whose budget ran out finish inside the fetch).
            fetched = bool(self._inflight)
            self._drain_inflight()
            return fetched
        dev = self.device
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
            logits = self._step(tokens, _to_device(decoding, torch.bool, dev))
            toks = pick_tokens(logits,
                               _to_device(self._temps, torch.float32, dev),
                               self._gen)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        except Exception as e:
            log.exception("decode step failed")
            self._reset(e)
            return False
        self.steps_run += 1
        self.batches_run = self.steps_run
        if self.engine_core == "async":
            self._dev_tok = toks
        # Whether this tick is a slot's last is pinned here: by fetch time
        # a later dispatch may have moved `remaining` on.
        ticked = []
        for i, sl in enumerate(self._slots):
            if not decoding[i]:
                continue
            sl["len"] = min(sl["len"] + 1, self.max_len)
            sl["remaining"] -= 1
            ticked.append((i, sl["remaining"] <= 0))
        self._inflight.append({"toks": toks, "slots": ticked, "done": done})
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
        try:
            toks = fl["toks"].tolist()
        except Exception as e:
            # Device errors of an asynchronous dispatch surface here.
            log.exception("decode step failed")
            self._reset(e)
            return
        for i, final in fl["slots"]:
            sl = self._slots[i]
            if sl is None:
                continue  # reclaimed by a reset before the fetch
            tok = toks[i]
            sl["out"].append(tok)
            self._last_tok[i] = tok
            _stream_event(sl["stream"], {"token": tok}, sl["rid"])
            if final:
                self._finish(i)

    def _drain_inflight(self) -> None:
        """Fetch every outstanding tick (preemption needs the host view
        current)."""
        while self._inflight:
            self._fetch_tick()

    def _device_busy(self) -> bool:
        """True while the newest dispatched-but-unfetched tick still runs
        on the device. Non-blocking: an Event query."""
        if not self._inflight:
            return False
        done = self._inflight[-1]["done"]
        return done is not None and not done.query()

    def _finish(self, i: int):
        sl = self._slots[i]
        self._release_slot(i)
        out = [int(t) for t in sl["out"]]
        if not sl["fut"].done():
            sl["fut"].set_result(out)
        _stream_event(sl["stream"], {"done": True, "tokens": out},
                      sl["rid"])
        self.requests_served += 1
        self._slots[i] = None

    def _reset(self, err):
        """After a device failure: fail every in-flight and backlogged
        request and rebuild the cache from scratch."""
        self._inflight = []
        self._dev_tok = None
        self._tok_overrides = {}
        for i, sl in enumerate(self._slots):
            if sl is not None:
                _fail(sl["fut"], sl["stream"], err, sl["rid"])
            self._slots[i] = None
        for item in self._backlog:
            _fail(item[3], item[4], err, item[5])
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
      - decode: before each tick, slots whose next token opens a page get
        one through one masked assign_pages scatter;
      - exhaustion: with no page free, preempt the youngest request: free
        its pages and requeue it at the front of the backlog (its prompt
        and the tokens so far become its new prompt);
      - finish: pages go back to the free list.

    `max_len` rounds up to a page multiple; the prompt bucket is the
    page."""

    def __init__(self, model, cfg, max_slots: int = 8,
                 max_len: int = 2048, page: int = 128,
                 pool_pages: int | None = None,
                 max_prompt_len: int = 1024, prefix_cap: int = 256,
                 prefill_chunk: int = 0, engine_core: str = "async",
                 plain: bool = False):
        max_len = -(-max_len // page) * page
        self.page = page
        self.max_pages = max_len // page
        # Default pool: half the full reservation, plus the trash row.
        self.pool_pages = pool_pages or max_slots * self.max_pages // 2 + 1
        self.preemptions = 0
        self.prefix_cap = prefix_cap
        self.prefix_pages_reused = 0
        super().__init__(model, cfg, max_slots=max_slots, max_len=max_len,
                         prompt_bucket=page, max_prompt_len=max_prompt_len,
                         prefill_chunk=prefill_chunk,
                         engine_core=engine_core, plain=plain)

    def submit(self, tokens, max_new_tokens, temperature, stream=None):
        """Reject a prompt whose pages can never all be free at once:
        admission would retry it forever and block every later
        request."""
        pages = -(-len(tokens) // self.page)
        if pages > self.pool_pages - 1:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            _fail(fut, stream, ValueError(
                f"prompt needs {pages} pages but the pool has only "
                f"{self.pool_pages - 1} usable; raise --pool-pages"))
            return fut
        return super().submit(tokens, max_new_tokens, temperature,
                              stream=stream)

    # ---------- hooks ----------

    def _fresh_state(self):
        from container_engine_accelerators_tpu_torch.models.decode import (
            PageAllocator,
            PrefixIndex,
            init_paged_cache,
        )

        self._cache = init_paged_cache(self.cfg, self.max_slots,
                                       self.pool_pages, self.page,
                                       self.max_pages, self.device)
        self._alloc = PageAllocator(self.pool_pages)
        self.prefix_index = PrefixIndex(self._alloc, cap=self.prefix_cap)

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
        return i

    def _admit_one(self, item, slot_idx) -> bool:
        """False = not enough pages right now (item NOT consumed)."""
        from container_engine_accelerators_tpu_torch.models.decode import (
            PrefixIndex,
            set_slot_pages,
        )

        tokens, n_new, temp, fut, stream, rid = item
        page = self.page
        n_pages = -(-len(tokens) // page)
        if n_pages > self.pool_pages - 1:
            # A preempted request's regrown prompt can outgrow the pool
            # that submit() checked: fail it, do not block the backlog.
            _fail(fut, stream, RuntimeError(
                f"request needs {n_pages} prompt pages but the pool has "
                f"only {self.pool_pages - 1} usable; raise --pool-pages"),
                rid)
            return True  # consumed
        # Share the longest indexed chain of FULL prompt pages; the page
        # holding the last prompt token stays private, since decode
        # writes into it.
        n_full = (len(tokens) - 1) // page
        keys = PrefixIndex.chain_keys(tokens, page, n_full)
        shared = self.prefix_index.match(keys)
        fresh = self._try_alloc(n_pages - len(shared))
        if fresh is None:
            self._alloc.free(shared)  # drop the refs; entries stay
            return False
        p_len = len(shared) * page
        rows = shared + fresh
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
        return True

    def _run_chunk(self, slot_idx, tokens, start, new_len):
        from container_engine_accelerators_tpu_torch.models.decode import (
            prefill_suffix_paged,
        )

        # The start is length[slot] on the device, set by admission or
        # by the previous chunk.
        last, self._cache = prefill_suffix_paged(
            self.model, self._cache, slot_idx, tokens, new_len, self.cfg,
            plain=self.plain)
        return last

    def _step(self, tokens, active):
        from container_engine_accelerators_tpu_torch.models.decode import (
            decode_step_paged,
        )

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
        """Give every decoding slot whose next write opens a page one
        fresh page (one masked scatter), preempting on exhaustion. One
        round is enough: a tick writes one position per slot. False = a
        device error was handled."""
        from container_engine_accelerators_tpu_torch.models.decode import (
            assign_pages,
        )

        s, page = self.max_slots, self.page
        mask, pos, rws = [False] * s, [0] * s, [0] * s
        for i, sl in enumerate(self._slots):
            if sl is None or sl["pending"] or sl["remaining"] <= 0:
                # Prefilling slots hold all their prompt pages; drained
                # slots (final token dispatched, fetch pending) never
                # tick again, so a page for them would leak.
                continue
            target = min(sl["len"] // page, self.max_pages - 1)
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
            return True
        dev = self.device
        try:
            self._cache = assign_pages(
                self._cache, _to_device(pos, torch.long, dev),
                _to_device(rws, torch.int32, dev),
                _to_device(mask, torch.bool, dev))
        except Exception as e:
            log.exception("assign_pages failed")
            self._reset(e)
            return False
        return True


def make_server(engine, port: int) -> ThreadingHTTPServer:
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
                return self._send({
                    "ok": True,
                    "batches": engine.batches_run,
                    "requests": engine.requests_served,
                    "worker_alive": engine.thread.is_alive(),
                    "worker_restarts": engine.worker_restarts})
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
                if req.get("stream"):
                    stream_q: queue.Queue = queue.Queue()
                    engine.submit(*args, stream=stream_q)
                    return self._stream_response(stream_q)
                fut = engine.submit(*args)
                return self._send({"tokens": fut.result(timeout=120)})
            except (KeyError, ValueError, TypeError) as e:
                return self._send({"error": str(e)}, 400)
            except Exception as e:
                return self._send({"error": str(e)}, 500)

    return ThreadingHTTPServer(("", port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tiny", action="store_true",
                   help="random llama_tiny (the only model this port "
                        "loads so far; required)")
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
    p.add_argument("--engine-core", choices=("async", "sync"),
                   default="async",
                   help="async = dispatch batch (window) or tick "
                        "(continuous/paged) t+1 while t runs on the "
                        "device and fetch one behind; sync = fetch each "
                        "at once (the token-identity reference)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.tiny:
        p.error("checkpoints are not ported yet; pass --tiny")
    logging.basicConfig(level=logging.INFO)

    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    model, cfg = load_model(device=args.device)
    if args.kv_dtype != "bf16":
        # One cfg field carries the mode to every engine's cache
        # allocation (init_cache, init_slot_cache, init_paged_cache).
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_dtype)
        log.info("serving an %s KV cache", args.kv_dtype)
    if args.weight_dtype == "int8":
        model = quantize_llama_params(model)
        log.info("serving int8-quantized weights")
    if args.engine == "paged":
        engine = PagedContinuousEngine(
            model, cfg, max_slots=args.max_batch, max_len=args.max_len,
            page=args.page_size, pool_pages=args.pool_pages,
            prefix_cap=args.prefix_cache_cap,
            prefill_chunk=args.prefill_chunk, engine_core=args.engine_core)
    elif args.engine == "continuous":
        engine = ContinuousEngine(
            model, cfg, max_slots=args.max_batch, max_len=args.max_len,
            prefill_chunk=args.prefill_chunk, engine_core=args.engine_core)
    else:
        engine = BatchingEngine(model, cfg, max_batch=args.max_batch,
                                window_ms=args.batch_window_ms,
                                engine_core=args.engine_core)
    server = make_server(engine, args.port)
    log.info("serving on :%d (/generate, /healthz) on %s, %s engine",
             args.port, model.device, args.engine)
    try:
        server.serve_forever()
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
