#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch/CUDA port's serving path on one GPU.

  python3 chip_smoke.py          # from the root of a checkout, one H100

Phases, one JSON line each:
  device   the card's name and power limit (nvidia-smi);
  build    compile the port's CUDA kernels from this checkout;
  k1_*     kernels/decode_attention.cu (contiguous) against
           decode_attention_plain at Llama-3-8B widths, timed beside the
           plain version and F.scaled_dot_product_attention (timing only);
  k2_*     kernels/int8_matmul.cu against int8_matmul_plain, timed beside
           torch.matmul on the dequantized weight (timing only);
  k3_*     the paged entry of kernels/decode_attention.cu against
           paged_decode_attention_plain at 8B widths and page 128, timed
           beside the plain version, K1 on a contiguous copy of the same
           keys, and SDPA on that copy (timing only);
  serve    llama3_8b at full width and depth, random bf16 weights from a
           seed, behind BatchingEngine + make_server on an ephemeral
           port: concurrent requests in two buckets plus one streamed;
           then decode ms per step at batch 8 and a torch.profiler
           breakdown of the device time of a decode step;
  int8     the same weights through quantize_llama_params and generate;
  paged    the same weights behind PagedContinuousEngine + make_server:
           one request that leaves a 256-token prefix in the prefix
           cache, then a concurrent burst of short, prefix-sharing, long
           (two prefill chunks) and streamed requests; then the paged
           decode tick at 8 slots and its torch.profiler breakdown;
  paged_preempt  a second paged engine with a pool of 8 usable pages and
           3 requests that need 12: requests are preempted and requeued;
  continuous  ContinuousEngine (slot cache, K1 with per-slot lengths)
           behind make_server on a burst of short and streamed requests.
Then each phase's seconds, the kernels line (launches on the main path,
errors, times and bounds) and, last, {"ok": true, "device": {...}}. Any
failure exits non-zero before that line. Without CUDA, or outside a
checkout of the repository, it exits non-zero at once.

Times come from CUDA events around a run of launches that the host
queued while the card was held busy, so they are the card's time, not
the host's. Bounds use the H100 SXM's published rates.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
PEAK_FLOPS = {"bf16": 989e12,    # dense tensor-core rate
              "f32": 67e12}      # CUDA cores
SEED = 0

K1_SOURCE = "container_engine_accelerators_tpu_torch/kernels/decode_attention.cu"
K2_SOURCE = "container_engine_accelerators_tpu_torch/kernels/int8_matmul.cu"
K3_SOURCE = K1_SOURCE
K1_REPLACES = "container_engine_accelerators_tpu/ops/decode_attention.py:282"
K2_REPLACES = "container_engine_accelerators_tpu/ops/quant.py:214"
K3_REPLACES = "container_engine_accelerators_tpu/ops/decode_attention.py:391"
# K1, per output row: bf16 output, f32 math on both sides, so a
# different summation order moves an element by at most one bf16 ulp,
# 2^-7 of the row's largest |o|. Held per row, since a long cache
# averages |o| down and one absolute bound would hide dropped keys.
K1_ROW_RTOL, K1_ROW_ATOL = 2 ** -7, 1e-6
K2_TOL = {"bf16": 2 ** -8, "f32": 1e-4}   # relative to max |y|
LOGITS_RTOL = 5e-2   # kernel path vs plain path, relative to max |logit|


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms: the launches are queued while a
    sleep kernel holds the card, so host overhead does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _row_errors(got, want, d: int, what: str) -> tuple[float, float]:
    """(max |diff|, worst row's max |diff| / max |o|). Fails unless each
    output row is within K1_ROW_RTOL of its own max |o| (+ K1_ROW_ATOL)."""
    row_err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
    row_scale = want.float().abs().reshape(-1, d).amax(-1)
    rel = (row_err / row_scale).max().item()
    require(bool((row_err <= K1_ROW_RTOL * row_scale + K1_ROW_ATOL).all()),
            f"{what}: a row's max|diff| exceeds {K1_ROW_RTOL} of its "
            f"max|o| (worst {rel})")
    return row_err.max().item(), rel


def _attention_work(torch, lens_b, t: int, max_len: int, b: int, hq: int,
                    hkv: int, d: int) -> tuple[float, float, object]:
    """(bytes, flops, mask) of attention these inputs need: q and out
    once, the live K/V rows once, 4*D flops per (query row, visible key);
    and the SDPA mask [B, 1, T, max_len] of the same function."""
    key_pos = torch.arange(max_len, device=lens_b.device)
    t_idx = torch.arange(t, device=lens_b.device)
    live = (lens_b + t).clamp(max=max_len)
    mask = ((key_pos[None, None, :] < live[:, None, None])
            & (key_pos[None, None, :]
               <= lens_b[:, None, None] + t_idx[None, :, None]))
    n_live = live.sum().item()
    visible = torch.minimum(lens_b[:, None] + t_idx[None, :] + 1,
                            live[:, None]).sum().item()
    n_bytes = 2 * (2 * b * t * hq * d) + 2 * (2 * n_live * hkv * d)
    return n_bytes, 4 * d * hq * visible, mask[:, None]


def _sdpa(F, q, k, v, mask):
    """One PyTorch call computing the same attention on a contiguous
    cache: the library yardstick (timing only; the port never calls
    it)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


# ---------------------------------------------------------------- K1

def k1_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    hq, hkv, d, max_len = 32, 8, 128, 2048
    cases = [
        ("decode_slots", 1, 8,
         [0, 1, 127, 128, 129, 2047, 1000, 513]),
        ("decode_scalar", 1, 8, 1500),
        ("prefill_128", 128, 8, 0),
        ("prefill_512", 512, 2, [0, 1024]),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, t, b, lens in cases:
        q = torch.randn(b, t, hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, max_len, hkv, d, generator=gen,
                        device=dev).bfloat16()
        v = torch.randn(b, max_len, hkv, d, generator=gen,
                        device=dev).bfloat16()
        cache_len = (torch.tensor(lens, dtype=torch.int32, device=dev)
                     if isinstance(lens, list) else lens)
        got = decode_attention_cuda(q, k, v, cache_len)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, cache_len)
        err, rel = _row_errors(got, want, d, f"K1 {name}")
        lens_b = (torch.as_tensor(lens, device=dev).reshape(-1)
                  .expand(b).long())
        n_bytes, flops, mask = _attention_work(torch, lens_b, t, max_len, b,
                                               hq, hkv, d)
        ms = device_ms(torch, lambda: decode_attention_cuda(q, k, v,
                                                            cache_len))
        plain_ms = device_ms(torch, lambda: decode_attention_plain(
            q, k, v, cache_len), iters=5)
        library_ms = device_ms(torch, _sdpa(F, q, k, v, mask), iters=5)
        bms, by = bound_ms(n_bytes, flops, "bf16")
        results[name] = {"max_abs_err": err, "max_row_rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bms,
                         "bound_by": by}
        emit({"phase": f"k1_{name}", "T": t, "B": b, "Hq": hq, "Hkv": hkv,
              "D": d, "max_len": max_len, "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL,
              **results[name]})
        del q, k, v, got, want, mask
    return results


# ---------------------------------------------------------------- K2

def k2_phase(torch, dev) -> dict:
    from container_engine_accelerators_tpu_torch.ops.quant import (
        dequantize,
        int8_matmul_cuda,
        int8_matmul_plain,
        quantize_weights,
    )

    cases = [("w_gate_bf16", 8, 4096, 14336, torch.bfloat16, "bf16"),
             ("lm_head_f32", 8, 4096, 128256, torch.float32, "f32")]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    results = {}
    for name, t, d, f, dtype, kind in cases:
        x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
        qw = quantize_weights(
            torch.randn(d, f, generator=gen, device=dev) * d ** -0.5)
        got = int8_matmul_cuda(x, qw)
        torch.cuda.synchronize()
        want = int8_matmul_plain(x, qw)
        err = (got.float() - want.float()).abs().max().item()
        tol = K2_TOL[kind] * want.float().abs().max().item()
        require(err <= tol, f"K2 {name}: max|diff| {err} > {tol}")
        w_deq = dequantize(qw, dtype)
        ms = device_ms(torch, lambda: int8_matmul_cuda(x, qw))
        plain_ms = device_ms(torch, lambda: int8_matmul_plain(x, qw),
                             iters=5)
        library_ms = device_ms(torch, lambda: torch.matmul(x, w_deq))
        item = x.element_size()
        n_bytes = t * d * item + d * f + 4 * f + t * f * item
        bms, by = bound_ms(n_bytes, 2 * t * d * f, kind)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bms,
                         "bound_by": by}
        emit({"phase": f"k2_{name}", "T": t, "D": d, "F": f,
              "x_dtype": kind, "tol": tol, **results[name]})
        del x, qw, got, want, w_deq
    return results


# ---------------------------------------------------------------- K3

def _page_pool(torch, dev, gen, lens, t, page, max_pages, hkv, d):
    """(k_pool, v_pool, tables): each slot's live pages at permuted pool
    rows, and table entries past them 0 or out-of-range garbage."""
    live_pages = [-(-(n + t) // page) for n in lens]
    n_pages = sum(live_pages) + 8
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = torch.randint(-3, n_pages + 3, (len(lens), max_pages),
                           generator=gen, device=dev, dtype=torch.int32)
    tables[:, ::2] = 0
    used = 0
    for i, n in enumerate(live_pages):
        tables[i, :n] = perm[used:used + n].int()
        used += n
    shape = (n_pages, page, hkv, d)
    k_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=dev).bfloat16()
    return k_pool, v_pool, tables


def k3_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_plain,
    )

    hq, hkv, d, page, max_pages = 32, 8, 128, 128, 16
    max_len = page * max_pages
    cases = [
        ("decode", 1, [0, 1, 127, 128, 129, 2047, 1000, 513]),
        ("prefill_chunk_512", 512, [512]),
        ("prefix_suffix_128", 128, [256]),
    ]
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    results = {}
    for name, t, lens in cases:
        b = len(lens)
        k_pool, v_pool, tables = _page_pool(torch, dev, gen, lens, t, page,
                                            max_pages, hkv, d)
        q = torch.randn(b, t, hq, d, generator=gen, device=dev).bfloat16()
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = paged_decode_attention_cuda(q, k_pool, v_pool, lens_t, tables)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(q, k_pool, v_pool, lens_t,
                                            tables)
        err, rel = _row_errors(got, want, d, f"K3 {name}")
        # The same keys in a contiguous cache: K1 there shows what the
        # paging costs, and SDPA there is the library yardstick (no one
        # PyTorch call computes paged attention).
        rows = tables.long().clamp(0, k_pool.shape[0] - 1)
        k = k_pool[rows].reshape(b, max_len, hkv, d).contiguous()
        v = v_pool[rows].reshape(b, max_len, hkv, d).contiguous()
        n_bytes, flops, mask = _attention_work(torch, lens_t.long(), t,
                                               max_len, b, hq, hkv, d)
        n_bytes += tables.numel() * 4 + lens_t.numel() * 4
        ms = device_ms(torch, lambda: paged_decode_attention_cuda(
            q, k_pool, v_pool, lens_t, tables))
        plain_ms = device_ms(torch, lambda: paged_decode_attention_plain(
            q, k_pool, v_pool, lens_t, tables), iters=5)
        k1_ms = device_ms(torch, lambda: decode_attention_cuda(q, k, v,
                                                               lens_t))
        library_ms = device_ms(torch, _sdpa(F, q, k, v, mask), iters=5)
        bms, by = bound_ms(n_bytes, flops, "bf16")
        results[name] = {"max_abs_err": err, "max_row_rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "k1_contiguous_ms": k1_ms,
                         "library_ms": library_ms,
                         "library": "SDPA on a contiguous copy",
                         "bound_ms": bms, "bound_by": by}
        emit({"phase": f"k3_{name}", "T": t, "slots": b, "Hq": hq,
              "Hkv": hkv, "D": d, "page": page, "max_pages": max_pages,
              "n_pages": k_pool.shape[0], "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL,
              **results[name]})
        del q, k, v, k_pool, v_pool, got, want, mask
    return results


# ---------------------------------------------------------------- serve

def _post(url: str, body: dict) -> tuple[dict | list, float, float]:
    """(answer, sent, done): the JSON answer, or a stream's events, and
    the monotonic clock when the request went out and when its answer
    was in. The server runs in this process, so its events' `ts` are on
    the same clock."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    sent = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as resp:
        text = resp.read().decode()
    done = time.monotonic()
    if body.get("stream"):
        events = [json.loads(line[len("data: "):])
                  for line in text.split("\n\n") if line]
        return events, sent, done
    return json.loads(text), sent, done


def _check_answer(tokens: list, prompt: list, n_new: int, vocab: int,
                  what: str) -> None:
    require(len(tokens) == len(prompt) + n_new,
            f"{what}: {len(tokens)} tokens, want {len(prompt) + n_new}")
    require(tokens[:len(prompt)] == prompt, f"{what}: prompt not echoed")
    require(all(0 <= tok < vocab for tok in tokens[len(prompt):]),
            f"{what}: token outside the vocabulary")


def _answer_tokens(req: dict, ans) -> list:
    """The tokens of one answer; a stream's token events must be its
    done tokens."""
    if req.get("stream"):
        require("done" in ans[-1], f"stream did not finish: {ans[-1]}")
        toks = ans[-1]["tokens"]
        require([e["token"] for e in ans[:-1]]
                == toks[len(req["tokens"]):], "stream tokens")
        return toks
    require("tokens" in ans, f"request failed: {ans}")
    return ans["tokens"]


def _check_burst(requests: list, answers: list, vocab: int,
                 what: str) -> int:
    """Check every answer of a burst; returns the tokens generated."""
    generated = 0
    for req, (ans, _, _) in zip(requests, answers):
        _check_answer(_answer_tokens(req, ans), req["tokens"],
                      req["max_new_tokens"], vocab, what)
        generated += req["max_new_tokens"]
    return generated


def _stream_ttft_s(requests: list, answers: list) -> list:
    """Per streamed request: its first token event's `ts` minus the time
    it was sent (one monotonic clock, the server is in-process)."""
    return [ans[0]["ts"] - sent
            for req, (ans, sent, _) in zip(requests, answers)
            if req.get("stream")]


def _time_generate(torch, generate, model, prompt, cfg, n_new) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, prompt, cfg, n_new)
    torch.cuda.synchronize()
    del out
    return time.perf_counter() - t0


def step_times_ms(torch, generate, model, prompt, cfg) -> tuple[float, float]:
    """(prefill ms, decode ms per step): the time of generate with one
    new token (the prefill and its pick), and (time with 33 new tokens -
    with 1) / 32."""
    _time_generate(torch, generate, model, prompt, cfg, 2)   # warm
    short = _time_generate(torch, generate, model, prompt, cfg, 1)
    long = _time_generate(torch, generate, model, prompt, cfg, 33)
    return short * 1e3, (long - short) / 32 * 1e3


def profile_steps(torch, step, steps: int = 4) -> dict:
    """Device time of `steps` calls of step() by kernel, from
    torch.profiler: the busy time per step and the kernels that take
    most of it. None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        return {"busy_ms_per_step": None, "top": None}
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"busy_ms_per_step": busy_us / steps / 1e3,
            "top": {e.key[:60]: e.self_device_time_total / steps / 1e3
                    for e in kernels[:6]}}


def profile_decode(torch, dev, decode, model, cfg, batch,
                   steps: int = 4) -> dict:
    """profile_steps over decode steps of the contiguous cache at the
    batch's prompt length."""
    cache = decode.init_cache(cfg, batch.shape[0], batch.shape[1] + steps + 1,
                              dev)
    logits, cache = decode.decode_step(model, cache, batch, cfg)
    tok = logits[:, -1].argmax(dim=-1)

    def step():
        nonlocal cache, tok
        logits, cache = decode.decode_step(model, cache, tok[:, None], cfg)
        tok = logits[:, -1].argmax(dim=-1)

    return profile_steps(torch, step, steps)


@contextlib.contextmanager
def serving(engine):
    """make_server(engine) on an ephemeral port, in a thread; yields its
    URL. On exit the server and the engine stop, and their threads are
    joined."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        make_server,
    )

    srv = make_server(engine, 0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    try:
        yield f"http://localhost:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        engine.thread.join(timeout=60)
        server_thread.join(timeout=60)
    require(not engine.thread.is_alive(), "engine worker did not stop")


def burst(url: str, requests: list) -> tuple[list, float, float]:
    """Send all requests at once; (answers, start, end of the last)."""
    t_start = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
        answers = list(pool.map(lambda r: _post(url, r), requests))
    return answers, t_start, max(done for _, _, done in answers)


def healthz(url: str) -> dict:
    with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def serve_phase(torch, dev, np) -> tuple[dict, object, object]:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        BatchingEngine,
    )
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_params,
        llama3_8b,
    )

    cfg = llama3_8b()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.num_params(), "8B parameter count")
    rs = np.random.RandomState(SEED)

    def prompt(n):
        return rs.randint(0, cfg.vocab_size, size=n).tolist()

    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)]
                + [{"tokens": prompt(512), "max_new_tokens": 16}
                   for _ in range(2)]
                + [{"tokens": prompt(64), "max_new_tokens": 8,
                    "stream": True}])

    engine = BatchingEngine(model, cfg, max_batch=8, window_ms=250.0,
                            engine_core="async")
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        answers, t_start, t_end = burst(url, requests)
        # A repeated greedy request answers the same tokens.
        repeat = {"tokens": requests[0]["tokens"], "max_new_tokens": 32}
        again = [_post(url, repeat)[0]["tokens"] for _ in range(2)]
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)

    generated = _check_burst(requests, answers, cfg.vocab_size, "serve")
    require(again[0] == again[1], "repeated greedy request changed")
    _check_answer(again[0], repeat["tokens"], 32, cfg.vocab_size, "repeat")
    require(health["requests"] == len(requests) + 2 and
            health["worker_alive"], f"healthz {health}")
    require(launches.get("decode_attention", 0) > 0,
            "serve path launched no decode_attention kernel")

    # Prefill logits: kernel path against the plain path on the card.
    p = torch.tensor([requests[0]["tokens"]], device=dev)
    logits = {}
    for plain in (False, True):
        cache = decode.init_cache(cfg, 1, 160, dev)
        logits[plain], _ = decode.decode_step(model, cache, p, cfg,
                                              plain=plain)
    diff = (logits[False] - logits[True]).abs().max().item()
    scale = logits[True].abs().max().item()
    require(diff <= LOGITS_RTOL * scale,
            f"prefill logits kernel vs plain {diff} > {LOGITS_RTOL} * {scale}")
    # Random weights leave near-ties at the top of a 128k vocabulary: a
    # first-token margin below `diff` lets the two paths pick apart.
    top2 = logits[True][0, -1].topk(2).values
    margin = (top2[0] - top2[1]).item()
    del logits
    kern = decode.generate(model, p, cfg, 16)
    plain_out = decode.generate(model, p, cfg, 16, plain=True)
    match = int((kern[0, 128:] == plain_out[0, 128:]).sum().item())

    batch = torch.tensor([r["tokens"] for r in requests[:8]], device=dev)
    prefill_ms, step_ms = step_times_ms(torch, decode.generate, model, batch,
                                        cfg)
    profile = profile_decode(torch, dev, decode, model, cfg, batch)
    result = {
        "phase": "serve", "model": "llama3_8b", "n_layers": cfg.n_layers,
        "params": n_params, "init_s": init_s,
        "requests": len(requests), "batches": health["batches"],
        "time_to_first_batch_s": min(d for _, _, d in answers) - t_start,
        "burst_s": t_end - t_start,
        "generated_tokens_per_s": generated / (t_end - t_start),
        "prefill_ms_b8_t128": prefill_ms,
        "decode_ms_per_step_b8": step_ms,
        "device_busy_ms_per_step_b8": profile["busy_ms_per_step"],
        "device_idle_share": (None if profile["busy_ms_per_step"] is None
                              else 1 - profile["busy_ms_per_step"] / step_ms),
        "top_kernels_ms_per_step": profile["top"],
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "prefill_logits_max_abs_diff": diff, "prefill_logits_max_abs": scale,
        "logits_rtol": LOGITS_RTOL,
        "greedy_tokens_matching_plain": f"{match}/16",
        "plain_first_token_top2_margin": margin,
    }
    emit(result)
    return result, model, cfg


def int8_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    qmodel = quantize_llama_params(model)
    rs = np.random.RandomState(SEED + 2)
    batch = torch.tensor(rs.randint(0, cfg.vocab_size, size=(8, 128)),
                         device=dev)
    kernels.reset_launches()
    out = decode.generate(qmodel, batch, cfg, 16)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    require(out.shape == (8, 144), f"int8 generate shape {out.shape}")
    require(torch.equal(out[:, :128], batch), "int8 prompt not echoed")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            "int8 token outside the vocabulary")
    for name in ("decode_attention", "int8_matmul"):
        require(launches.get(name, 0) > 0, f"int8 path launched no {name}")

    cache = decode.init_cache(cfg, 1, 128, dev)
    kern, _ = decode.decode_step(qmodel, cache, batch[:1], cfg)
    cache = decode.init_cache(cfg, 1, 128, dev)
    plain, _ = decode.decode_step(qmodel, cache, batch[:1], cfg, plain=True)
    diff = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    require(diff <= LOGITS_RTOL * scale,
            f"int8 prefill logits kernel vs plain {diff} > "
            f"{LOGITS_RTOL} * {scale}")
    del kern, plain
    prefill_ms, step_ms = step_times_ms(torch, decode.generate, qmodel,
                                        batch, cfg)
    result = {"phase": "int8", "model": "llama3_8b", "batch": 8,
              "prompt": 128, "new_tokens": 16, "launches": launches,
              "prefill_logits_max_abs_diff": diff,
              "prefill_logits_max_abs": scale,
              "prefill_ms_b8_t128": prefill_ms,
              "decode_ms_per_step_b8": step_ms}
    emit(result)
    return result


# ---------------------------------------------------------------- engines

def _prompts(np, cfg, seed):
    rs = np.random.RandomState(seed)
    return lambda n: rs.randint(0, cfg.vocab_size, size=n).tolist()


def paged_tick(torch, dev, np, model, cfg, ticks: int = 16) -> dict:
    """The paged decode tick at 8 active slots (page 128, the default
    pool of 65 pages): each slot prefilled with 128 tokens, then ticks
    of decode_step_paged + argmax. Wall ms per tick, device-synchronised
    around `ticks` ticks, and the torch.profiler breakdown of 4 more."""
    from container_engine_accelerators_tpu_torch.models import decode

    slots, page, max_pages, n_pages = 8, 128, 16, 65
    cache = decode.init_paged_cache(cfg, slots, n_pages, page, max_pages,
                                    dev)
    prompt = _prompts(np, cfg, SEED + 5)
    for s in range(slots):
        rows = [1 + 2 * s, 2 + 2 * s] + [0] * (max_pages - 2)
        decode.set_slot_pages(cache, s, torch.tensor(rows, dtype=torch.int32,
                                                     device=dev), 0)
        _, cache = decode.prefill_suffix_paged(
            model, cache, s, torch.tensor(prompt(128), device=dev), 128, cfg)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    tok = torch.zeros(slots, dtype=torch.long, device=dev)

    def tick():
        nonlocal cache, tok
        logits, cache = decode.decode_step_paged(model, cache, tok, active,
                                                 cfg)
        tok = logits.argmax(dim=-1)

    for _ in range(4):
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    profile = profile_steps(torch, tick)
    busy = profile["busy_ms_per_step"]
    return {"paged_decode_tick_ms_8_slots": tick_ms,
            "tick_cache_lengths": [128 + 4, 128 + 4 + ticks + 4],
            "device_busy_ms_per_tick": busy,
            "device_idle_share": None if busy is None else 1 - busy / tick_ms,
            "top_kernels_ms_per_tick": profile["top"]}


def paged_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )
    from container_engine_accelerators_tpu_torch.models import decode

    prompt = _prompts(np, cfg, SEED + 3)
    prefix = prompt(256)
    warm = {"tokens": prefix + prompt(128), "max_new_tokens": 16}
    hits = [{"tokens": prefix + prompt(128), "max_new_tokens": 16}
            for _ in range(3)]
    # The long prompts go last, so the slots they join are decoding.
    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)] + hits
                + [{"tokens": prompt(64), "max_new_tokens": 16,
                    "stream": True} for _ in range(2)]
                + [{"tokens": prompt(1024), "max_new_tokens": 16}
                   for _ in range(2)])
    engine = PagedContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                                   page=128, prefix_cap=256,
                                   prefill_chunk=512, engine_core="async")
    # Every prefill chunk as (request id, start, new_len, steps_run).
    chunks = []
    run_chunk = engine._run_chunk

    def logged_chunk(slot, tokens, start, new_len):
        chunks.append((engine._slots[slot]["rid"], start, new_len,
                       engine.steps_run))
        return run_chunk(slot, tokens, start, new_len)

    engine._run_chunk = logged_chunk
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        first = _post(url, warm)
        answers, t_start, t_end = burst(url, requests)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)

    _check_answer(_answer_tokens(warm, first[0]), warm["tokens"], 16,
                  cfg.vocab_size, "paged warm-up")
    generated = _check_burst(requests, answers, cfg.vocab_size, "paged")
    require(health["requests"] == 1 + len(requests) and
            health["worker_alive"], f"healthz {health}")
    require(engine.prefix_pages_reused >= 6,
            f"prefix pages reused {engine.prefix_pages_reused} < 6")
    require([c[3] for c in chunks] == engine.prefill_chunk_trace,
            "chunk log disagrees with prefill_chunk_trace")
    by_rid: dict = {}
    for rid, start, new_len, steps in chunks:
        by_rid.setdefault(rid, []).append((start, new_len, steps))
    split = [c for c in by_rid.values() if len(c) > 1]
    require(len(split) == 2 and all(
        [c[:2] for c in cs] == [(0, 512), (512, 1024)] and cs[1][2] > cs[0][2]
        for cs in split),
        f"1024-token prompts: want two chunks with decode steps between, "
        f"got {split}")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            f"leaked pages: {engine.pages_in_use} in use, "
            f"{engine.prefix_index.pages_held()} held by the prefix index")
    require(launches.get("paged_decode_attention", 0) > 0,
            "paged path launched no paged_decode_attention kernel")
    # Not gated: with random 8B weights, near-ties let bf16 paths part.
    matches = []
    for req, (ans, _, _) in zip(hits, answers[8:11]):
        n = len(req["tokens"])
        ref = decode.generate(model, torch.tensor([req["tokens"]],
                                                  device=dev), cfg, 16)
        matches.append(sum(a == b for a, b in
                           zip(ans["tokens"][n:], ref[0, n:].tolist())))
    counters = {name: getattr(engine, name) for name in (
        "prefix_pages_reused", "prefills_run", "prefill_chunks_run",
        "prefill_tokens_run", "preemptions")}
    del engine, chunks
    result = {
        "phase": "paged", "model": "llama3_8b", "max_slots": 8,
        "max_len": 2048, "page": 128, "pool_pages": 65,
        "prefill_chunk": 512, "requests": 1 + len(requests),
        "burst_requests": len(requests), "burst_s": t_end - t_start,
        "generated_tokens_per_s": generated / (t_end - t_start),
        "stream_ttft_s": _stream_ttft_s(requests, answers),
        "decode_steps": health["batches"],
        **counters,
        "long_prompt_chunks": split,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "prefix_hit_tokens_matching_generate": [f"{m}/16" for m in matches],
        **paged_tick(torch, dev, np, model, cfg),
    }
    emit(result)
    return result


def paged_preempt_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 6)
    n_new = 250
    prompts = [prompt(200) for _ in range(3)]
    # 8 usable pages; each request grows to 450 tokens, 4 pages: 12.
    engine = PagedContinuousEngine(model, cfg, max_slots=3, max_len=2048,
                                   page=128, pool_pages=9,
                                   prefill_chunk=512, engine_core="async")
    try:
        kernels.reset_launches()
        t0 = time.monotonic()
        futs = [engine.submit(p, n_new, 0.0) for p in prompts]
        outs = [f.result(timeout=600) for f in futs]
        seconds = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
    finally:
        engine.stop()
        engine.thread.join(timeout=60)
    require(not engine.thread.is_alive(), "engine worker did not stop")
    for p, out in zip(prompts, outs):
        _check_answer(out, p, n_new, cfg.vocab_size, "paged_preempt")
    require(engine.preemptions > 0, "no request was preempted")
    require(engine.requests_served == 3, "not every request finished")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            "leaked pages after preemption")
    require(launches.get("paged_decode_attention", 0) > 0,
            "preempt path launched no paged_decode_attention kernel")
    result = {"phase": "paged_preempt", "max_slots": 3, "pool_pages": 9,
              "prompt": 200, "new_tokens": n_new,
              "preemptions": engine.preemptions,
              "prefills_run": engine.prefills_run, "seconds": seconds,
              "generated_tokens_per_s": 3 * n_new / seconds,
              "launches": launches}
    emit(result)
    return result


def continuous_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        ContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 7)
    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)]
                + [{"tokens": prompt(64), "max_new_tokens": 16,
                    "stream": True} for _ in range(2)])
    engine = ContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                              prefill_chunk=512, engine_core="async")
    with serving(engine) as url:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        answers, t_start, t_end = burst(url, requests)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        health = healthz(url)
    generated = _check_burst(requests, answers, cfg.vocab_size,
                             "continuous")
    require(health["requests"] == len(requests) and health["worker_alive"],
            f"healthz {health}")
    require(launches.get("decode_attention", 0) > 0,
            "continuous path launched no decode_attention kernel")
    result = {"phase": "continuous", "model": "llama3_8b", "max_slots": 8,
              "max_len": 2048, "requests": len(requests),
              "burst_s": t_end - t_start,
              "generated_tokens_per_s": generated / (t_end - t_start),
              "stream_ttft_s": _stream_ttft_s(requests, answers),
              "decode_steps": health["batches"],
              "max_memory_allocated_bytes": peak, "launches": launches}
    emit(result)
    return result


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from container_engine_accelerators_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2

    try:
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

        seconds = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            seconds[name] = time.perf_counter() - t0
            return out

        lib = timed("build", kernels.build)
        kernels.load()
        emit({"phase": "build", "seconds": seconds["build"],
              "library": os.path.basename(lib)})

        k1 = timed("k1", k1_phase, torch, dev)
        k2 = timed("k2", k2_phase, torch, dev)
        k3 = timed("k3", k3_phase, torch, dev)
        serve, model, cfg = timed("serve", serve_phase, torch, dev, np)
        int8 = timed("int8", int8_phase, torch, dev, np, model, cfg)
        paged = timed("paged", paged_phase, torch, dev, np, model, cfg)
        preempt = timed("paged_preempt", paged_preempt_phase, torch, dev,
                        np, model, cfg)
        cont = timed("continuous", continuous_phase, torch, dev, np, model,
                     cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})

    def launches(name):
        return sum(phase["launches"].get(name, 0)
                   for phase in (serve, int8, paged, preempt, cont))

    k1_main, k2_main, k3_main = (k1["decode_slots"], k2["w_gate_bf16"],
                                 k3["decode"])
    emit({"kernels": [
        {"name": "decode_attention", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches("decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k1.values()),
         **{key: k1_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}},
        {"name": "int8_matmul", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches("int8_matmul"),
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         **{key: k2_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": launches("paged_decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k3.values()),
         **{key: k3_main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "k1_contiguous_ms", "library")}},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
