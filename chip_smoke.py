#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch/CUDA port's serving path on one GPU.

  python3 chip_smoke.py          # from the root of a checkout, one H100

Phases, one JSON line each:
  device   the card's name and power limit (nvidia-smi);
  build    compile the port's CUDA kernels from this checkout;
  k1_*     kernels/decode_attention.cu against decode_attention_plain at
           Llama-3-8B widths, timed beside the plain version and
           F.scaled_dot_product_attention (timing only);
  k2_*     kernels/int8_matmul.cu against int8_matmul_plain, timed beside
           torch.matmul on the dequantized weight (timing only);
  serve    llama3_8b at full width and depth, random bf16 weights from a
           seed, behind BatchingEngine + make_server on an ephemeral
           port: concurrent requests in two buckets plus one streamed;
           then decode ms per step at batch 8 and a torch.profiler
           breakdown of the device time of a decode step;
  int8     the same weights through quantize_llama_params and generate.
Then the kernels line (launches on the main path, errors, times and
bounds) and, last, {"ok": true, "device": {...}}. Any failure exits
non-zero before that line. Without CUDA, or outside a checkout of the
repository, it exits non-zero at once.

Times come from CUDA events around a run of launches that the host
queued while the card was held busy, so they are the card's time, not
the host's. Bounds use the H100 SXM's published rates.
"""

from __future__ import annotations

import concurrent.futures
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
K1_REPLACES = "container_engine_accelerators_tpu/ops/decode_attention.py:282"
K2_REPLACES = "container_engine_accelerators_tpu/ops/quant.py:214"
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
        row_err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
        row_scale = want.float().abs().reshape(-1, d).amax(-1)
        err = row_err.max().item()
        rel = (row_err / row_scale).max().item()
        require(bool((row_err <= K1_ROW_RTOL * row_scale
                      + K1_ROW_ATOL).all()),
                f"K1 {name}: a row's max|diff| exceeds {K1_ROW_RTOL} of "
                f"its max|o| (worst {rel})")

        # SDPA yardstick: same mask, GQA heads, [B, H, T, S] views.
        lens_b = (torch.as_tensor(lens, device=dev).reshape(-1)
                  .expand(b).long())
        key_pos = torch.arange(max_len, device=dev)
        t_idx = torch.arange(t, device=dev)
        live = (lens_b + t).clamp(max=max_len)
        mask = ((key_pos[None, None, :] < live[:, None, None])
                & (key_pos[None, None, :]
                   <= lens_b[:, None, None] + t_idx[None, :, None]))
        mask = mask[:, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        ms = device_ms(torch, lambda: decode_attention_cuda(q, k, v,
                                                            cache_len))
        plain_ms = device_ms(torch, lambda: decode_attention_plain(
            q, k, v, cache_len), iters=5)
        library_ms = device_ms(torch, library, iters=5)
        # Work these inputs need: q and out once, the live K/V rows
        # once; 4*D flops per (query row, visible key).
        n_live = live.sum().item()
        visible = torch.minimum(lens_b[:, None] + t_idx[None, :] + 1,
                                live[:, None]).sum().item()
        n_bytes = 2 * (2 * b * t * hq * d) + 2 * (2 * n_live * hkv * d)
        flops = 4 * d * hq * visible
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


# ---------------------------------------------------------------- serve

def _post(url: str, body: dict) -> tuple[dict | list, float]:
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        text = resp.read().decode()
    done = time.perf_counter()
    if body.get("stream"):
        events = [json.loads(line[len("data: "):])
                  for line in text.split("\n\n") if line]
        return events, done
    return json.loads(text), done


def _check_answer(tokens: list, prompt: list, n_new: int, vocab: int,
                  what: str) -> None:
    require(len(tokens) == len(prompt) + n_new,
            f"{what}: {len(tokens)} tokens, want {len(prompt) + n_new}")
    require(tokens[:len(prompt)] == prompt, f"{what}: prompt not echoed")
    require(all(0 <= tok < vocab for tok in tokens[len(prompt):]),
            f"{what}: token outside the vocabulary")


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


def profile_decode(torch, dev, decode, model, cfg, batch,
                   steps: int = 4) -> dict:
    """Device time of decode steps by kernel, from torch.profiler: the
    busy time per step and the kernels that take most of it. None where
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache = decode.init_cache(cfg, batch.shape[0], batch.shape[1] + steps + 1,
                              dev)
    logits, cache = decode.decode_step(model, cache, batch, cfg)
    tok = logits[:, -1].argmax(dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, cache = decode.decode_step(model, cache, tok[:, None],
                                               cfg)
            tok = logits[:, -1].argmax(dim=-1)
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


def serve_phase(torch, dev, np) -> tuple[dict, object, object]:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        BatchingEngine,
        make_server,
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
    srv = make_server(engine, 0)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://localhost:{srv.server_address[1]}"
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t_start = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as pool:
            answers = list(pool.map(lambda r: _post(url, r), requests))
        t_end = max(done for _, done in answers)
        # A repeated greedy request answers the same tokens.
        repeat = {"tokens": requests[0]["tokens"], "max_new_tokens": 32}
        again = [_post(url, repeat)[0]["tokens"] for _ in range(2)]
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        engine.thread.join(timeout=60)
        server_thread.join(timeout=60)
    require(not engine.thread.is_alive(), "engine worker did not stop")

    generated = 0
    for req, (ans, _) in zip(requests, answers):
        if req.get("stream"):
            require("done" in ans[-1], "stream did not finish")
            toks = ans[-1]["tokens"]
            require([e["token"] for e in ans[:-1]]
                    == toks[len(req["tokens"]):], "stream tokens")
        else:
            require("tokens" in ans, f"request failed: {ans}")
            toks = ans["tokens"]
        _check_answer(toks, req["tokens"], req["max_new_tokens"],
                      cfg.vocab_size, "serve")
        generated += req["max_new_tokens"]
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
        "time_to_first_batch_s": min(d for _, d in answers) - t_start,
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

        t0 = time.perf_counter()
        lib = kernels.build()
        kernels.load()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": os.path.basename(lib)})

        k1 = k1_phase(torch, dev)
        k2 = k2_phase(torch, dev)
        serve, model, cfg = serve_phase(torch, dev, np)
        int8 = int8_phase(torch, dev, np, model, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    def launches(name):
        return (serve["launches"].get(name, 0)
                + int8["launches"].get(name, 0))

    k1_main, k2_main = k1["decode_slots"], k2["w_gate_bf16"]
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
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
