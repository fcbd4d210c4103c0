"""serve — batched HTTP inference server over the KV-cache decode path.

Window batching: requests are bucketed by (prompt length,
max_new_tokens, temperature), gathered for a short window, and decoded
as one batch through models/decode.generate.

  POST /generate  {"tokens": [...], "max_new_tokens": 16,
                   "temperature": 0.0, "stream": false}
      stream=true answers as Server-Sent Events: one
      `data: {"token": t}` per generated token, then
      `data: {"done": true, "tokens": [...]}`. The window engine emits
      them when the batch completes. Events carry a monotonic `ts`, a
      unix-epoch `t` and the request id `req`.
  GET  /healthz

  python -m container_engine_accelerators_tpu_torch.cli.serve --tiny --port 8000

Runs on the GPU unless `--device cpu` is given; without CUDA it exits
with an error instead of falling back. The request recorder, tracing and
the continuous and paged engines come with later slices; the engine
keeps the counters that /healthz reports.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
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

    def _to_device(self, rows: list) -> torch.Tensor:
        """Token rows as a long tensor on the model's device. On the card
        the copy goes through pinned memory without blocking, so it does
        not wait for the batch still running there."""
        host = torch.tensor(rows, dtype=torch.long)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

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
                tokens = self._to_device([list(item[0]) for item in batch])
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


def make_server(engine: BatchingEngine, port: int) -> ThreadingHTTPServer:
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
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--weight-dtype", choices=("bf16", "int8"),
                   default="bf16",
                   help="int8: per-output-channel int8 weight storage, "
                        "dequantized inside the matmul kernel")
    p.add_argument("--engine-core", choices=("async", "sync"),
                   default="async",
                   help="async = dispatch batch t+1 while batch t runs "
                        "on the device and fetch one batch behind; sync "
                        "= fetch every batch at once")
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
    if args.weight_dtype == "int8":
        model = quantize_llama_params(model)
        log.info("serving int8-quantized weights")
    engine = BatchingEngine(model, cfg, max_batch=args.max_batch,
                            window_ms=args.batch_window_ms,
                            engine_core=args.engine_core)
    server = make_server(engine, args.port)
    log.info("serving on :%d (/generate, /healthz) on %s", args.port,
             model.device)
    try:
        server.serve_forever()
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
