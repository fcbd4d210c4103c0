#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch/CUDA port's serving, training and node
health paths on one GPU.

  python3 chip_smoke.py          # from the root of a checkout, one H100

  python3 chip_smoke.py k4 [--batch B] [--seq S] [ROOT ...]
  python3 chip_smoke.py bwd [--batch B] [--seq S] [--train] [ROOT ...]
  python3 chip_smoke.py decode [--tick] [--prefill] [ROOT ...]
  python3 chip_smoke.py k2 [--int8] [ROOT ...]

`k4` times K4 alone beside SDPA's forward in the k4_* cases, B 4 x S
2048 unless asked otherwise, one JSON line. `bwd` times K5 and K6 (and
K4) in the same cases beside SDPA's backward, whole and with only q
requiring grad, one JSON line; with --train also the train phase's
8-layer llama3_8b step (median ms, device-busy ms, the flash kernels'
device ms a step from torch.profiler). `decode` times K1 and K3 in
every k1_* and k3_* case on bf16, int8 and int4 caches, one JSON line;
with --tick also the paged decode tick on llama3_8b (wall and
device-busy ms), with --prefill one llama3_8b prefill of 2 x 512 tokens
through decode_step (wall and device-busy ms, K1's ms and share of the
busy time). `k2` times K2 in every k2_* case beside its library call,
and K7 beside torch.mul in turns, one JSON line; with --int8 also
llama3_8b's prefill of 8 x 128 and decode step at batch 8 on bf16
weights and on their int8 copy (wall ms, device-busy ms, K2's ms and
the top kernels of each). Each ROOT, a checkout such as a `git archive` of a
parent unpacked under checkout_proof/, is timed in a process of its own
that imports the port from there, in the order given (parent, change,
change, parent), so that two versions compare within one call on one
card.

Phases, one JSON line each:
  device   the card's name and power limit (nvidia-smi);
  build    compile the port's CUDA kernels from this checkout;
  k1_*     kernels/decode_attention.cu (contiguous) against
           decode_attention_plain at Llama-3-8B widths, timed beside the
           plain version and F.scaled_dot_product_attention (timing only);
           every k1_* and k3_* line (all KV modes) names the body that ran
           (decode_split_kernel, or prefill_mma_kernel for prefill),
           its key-range splits, and its registers and spill bytes from
           ptxas's report;
  k2_*     kernels/int8_matmul.cu against int8_matmul_plain (and its
           bits repeated) at every call llama3_8b makes: the seven
           projections and the f32 lm_head at T 8, and prefill at T 1024
           and 512; timed cold (copies rotated past the L2) beside
           torch.matmul on the dequantized weight (timing only); each
           line names the body that ran, its token tile and splits of D,
           and its registers and spill bytes (none may spill);
  k3_*     the paged entry of kernels/decode_attention.cu against
           paged_decode_attention_plain at 8B widths and page 128, timed
           beside the plain version, K1 on a contiguous copy of the same
           keys, and SDPA on that copy (timing only);
  k1_int8_*, k1_int4_*, k3_int8_*, k3_int4_*  K1 and K3 on int8 and int4
           caches (the k1_* and k3_* cases) against their plain quantized
           versions, timed beside the plain version, the bf16 kernel on
           the same keys dequantized, and dequantize + SDPA (timing only);
  serve    llama3_8b at full width and depth, random bf16 weights from a
           seed, behind BatchingEngine + make_server on an ephemeral
           port: concurrent requests in two buckets plus one streamed;
           then decode ms per step at batch 8 and a torch.profiler
           breakdown of the device time of a decode step;
  int8     the same weights through quantize_llama_params and generate,
           the prefill logits against the plain path; then the prefill
           of 8 x 128 and the decode step at batch 8 on bf16 and int8
           weights: wall ms, device-busy ms, K2's ms, top kernels;
  paged    the same weights behind PagedContinuousEngine + make_server:
           one request that leaves a 256-token prefix in the prefix
           cache, then a concurrent burst of short, prefix-sharing, long
           (two prefill chunks) and streamed requests; then the paged
           decode tick at 8 slots and its torch.profiler breakdown;
  paged_preempt  a second paged engine with a pool of 8 usable pages and
           3 requests that need 12: requests are preempted and requeued;
  continuous  ContinuousEngine (slot cache, K1 with per-slot lengths)
           behind make_server on a burst of short and streamed requests;
  kv_quant the same weights on int8 and int4 KV caches: bytes per cached
           token of each layout; the paged phase's burst behind
           make_server (leak check, tokens/s, stream TTFT); the paged
           decode tick at 8 slots; one decode step's logits on the kernel
           path against the plain path on the same quantized cache, and
           the drift from bf16; paged_preempt's load on pools of the
           bf16 pool's bytes; a continuous-engine burst in each mode;
  k4_*, k5_*, k6_*  kernels/flash_attention.cu (forward, dq, dk/dv)
           against flash_fwd_plain, flash_bwd_dq_plain and
           flash_bwd_dkv_plain at the training shapes (B 4, S 2048, 32 q
           heads, 8 KV heads, D 128; causal, segmented and non-causal),
           timed beside the plain versions and SDPA's forward and
           backward (timing only; K5 beside the backward with only q
           requiring grad; the segmented case with the
           segment-and-causal boolean mask), naming SDPA's backend;
           each kernel's registers and spill bytes from ptxas's report
           on the library loaded (none may spill); k5_k6_* sets the
           pair's ms beside SDPA's whole backward;
  train    llama3_8b at full width and 8 of its 32 layers, random f32
           masters from a seed, trained for 6 steps at batch 4 x 2048 by
           fit (synthetic data, make_optimizer, 'dots' remat): step ms,
           tokens/s, MFU, peak memory, losses, launches per step, and a
           torch.profiler breakdown of one more step;
  train_parity  llama3_8b widths at 2 layers, batch 1 x 512: one
           make_train_step on the kernel path and on the plain path from
           the same weights, and the kernel path under 'none', 'dots' and
           'full' remat, which must give identical gradients;
  train_cli  cli.train --preset tiny --steps 3 on the card;
  health   the node health path: K7 (kernels/scale_demo.cu) as the
           node's workload; then K7 built with the whole [4096, 4096]
           array as one shared-memory tile (refused by ptxas), an
           allocation larger than the card and a benign bf16 matmul, each
           in a process of its own, their stderr the runtime log that a
           TPUHealthChecker over a TPUManager of the host's /dev scrapes
           (VMEM_OOM and HBM_OOM, every device still Healthy); then
           cli.inject_fault's HBM_ECC_UNCORRECTABLE for card 0 (nvidia0
           Unhealthy, one Warning Event, the node condition); K7 against
           x * 2.0 (exact), timed in turns with torch.mul (5 each).
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
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
KV_MODES = ("int8", "int4")
# Cache bytes of one token at llama3_8b widths (32 layers, 8 KV heads,
# head_dim 128, K and V): bf16 2 bytes a value; int8 1 byte plus a 4-byte
# scale per (layer, head); int4 half a byte plus the same scales.
KV_BYTES_PER_TOKEN = {"bf16": 131072, "int8": 67584, "int4": 34816}
# paged_preempt's pool of 9 pages (8 usable), and pools of the same
# bytes in the quantized layouts (rounded down).
PREEMPT_POOL_PAGES = {"bf16": 9, "int8": 17, "int4": 33}
K7_SOURCE = "container_engine_accelerators_tpu_torch/kernels/scale_demo.cu"
K7_REPLACES = "demo/tpu-error/real-fault/provoke_vmem_oom.py:24"
FLASH_SOURCE = "container_engine_accelerators_tpu_torch/kernels/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "container_engine_accelerators_tpu/ops/flash_attention.py:231",
    "flash_bwd_dq": "container_engine_accelerators_tpu/ops/flash_attention.py:475",
    "flash_bwd_dkv": "container_engine_accelerators_tpu/ops/flash_attention.py:523",
}
# K1, per output row: bf16 output, f32 math on both sides, so a
# different summation order moves an element by at most one bf16 ulp,
# 2^-7 of the row's largest |o|. Held per row, since a long cache
# averages |o| down and one absolute bound would hide dropped keys.
K1_ROW_RTOL, K1_ROW_ATOL = 2 ** -7, 1e-6
K2_TOL = {"bf16": 2 ** -8, "f32": 1e-4}   # relative to max |y|
LOGITS_RTOL = 5e-2   # kernel path vs plain path, relative to max |logit|
# K4-K6 hold outputs and gradients per row of D values: K4's output as
# K1's (one bf16 ulp, 2^-7 of the row's max), the gradients within 2^-6,
# since they round twice (ds to bf16 before its product, then the sum),
# and both plus an absolute 2^-14 of the tensor's largest |x|: ds =
# p * (dp - delta) cancels where dp is close to delta (always, in a
# causal row's first query), and the two versions' f32 dp differ by
# ~1e-6 of |do||v|. lse (f32, m + log l) within 1e-4.
FLASH_GRAD_ROW_RTOL, FLASH_TENSOR_ATOL, LSE_ATOL = 2 ** -6, 2 ** -14, 1e-4
# Train step, kernel path vs plain path (bf16 activations, 2 layers): the
# two part by bf16 ulps in the attention outputs and gradients, so the
# loss within 1e-2 relative and each weight's gradient within 5e-2 of
# its norm.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 5e-2
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 16, "flash_bwd_dq": 8,
                           "flash_bwd_dkv": 8}   # 8 layers, 'dots' remat
# The train step's device time by kind of kernel, from the kernel names
# torch.profiler reports (cuBLAS's are nvjet_* or *gemm*).
STEP_KERNEL_KINDS = {"matmul": ("nvjet", "gemm", "cutlass"),
                     "flash_attention": ("flash_",),
                     "copy": ("Memcpy", "Memset"),
                     "reduction": ("reduce_kernel",),
                     "elementwise": ("elementwise_kernel",),
                     "softmax_cross_entropy": ("softmax", "SoftMax",
                                               "nll_loss"),
                     "embedding": ("embedding",)}


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


def _row_errors(got, want, d: int, what: str, rtol: float = K1_ROW_RTOL,
                atol: float = K1_ROW_ATOL) -> tuple[float, float]:
    """(max |diff|, worst row's max |diff| / (max |o| + atol / rtol)).
    Fails unless each output row is within `rtol` of its own max |o|
    plus `atol`."""
    row_err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
    row_scale = want.float().abs().reshape(-1, d).amax(-1)
    rel = (row_err / (row_scale + atol / rtol)).max().item()
    require(bool((row_err <= rtol * row_scale + atol).all()),
            f"{what}: a row's max|diff| exceeds {rtol} of its "
            f"max|o| + {atol} (worst {rel})")
    return row_err.max().item(), rel


def _kv_row_bytes(d: int, mode: str) -> int:
    """Bytes of one cached (token, KV head) row of K or V: the payload,
    plus its f32 scale in the quantized modes."""
    return {"bf16": 2 * d, "int8": d + 4, "int4": d // 2 + 4}[mode]


def _attention_work(torch, lens_b, t: int, max_len: int, b: int, hq: int,
                    hkv: int, d: int, mode: str = "bf16"
                    ) -> tuple[float, float, object]:
    """(bytes, flops, mask) of attention these inputs need: q and out
    once, the live K/V rows (and scales) once, 4*D flops per (query row,
    visible key); and the SDPA mask [B, 1, T, max_len] of the same
    function."""
    key_pos = torch.arange(max_len, device=lens_b.device)
    t_idx = torch.arange(t, device=lens_b.device)
    live = (lens_b + t).clamp(max=max_len)
    mask = ((key_pos[None, None, :] < live[:, None, None])
            & (key_pos[None, None, :]
               <= lens_b[:, None, None] + t_idx[None, :, None]))
    n_live = live.sum().item()
    visible = torch.minimum(lens_b[:, None] + t_idx[None, :] + 1,
                            live[:, None]).sum().item()
    n_bytes = 2 * (2 * b * t * hq * d) + 2 * n_live * hkv * _kv_row_bytes(
        d, mode)
    return n_bytes, 4 * d * hq * visible, mask[:, None]


def _sdpa(F, q, k, v, mask):
    """One PyTorch call computing the same attention on a contiguous
    cache: the library yardstick (timing only; the port never calls
    it)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def decode_kernel_info(torch, dev, payload: str, keys: str, t: int, b: int,
                       hq: int, hkv: int, max_len: int) -> dict:
    """Which body of kernels/decode_attention.cu a K1/K3 call takes at
    head_dim 128, its key-range splits (ops/decode_attention.split_plan
    on this card's SM count) and its registers and spill bytes from
    ptxas's report."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )

    n_rows = t * (hq // hkv)
    kernel = ("decode_split_kernel" if n_rows <= da.DECODE_ROWS
              else "prefill_mma_kernel")
    report = ptxas_report(kernel, f"{payload}Payload", "Li128E",
                          f"{keys}Keys")
    return {"kernel": kernel, "splits": da.split_plan(
        b, hkv, n_rows, max_len, kernels.sm_count(dev)),
        "registers": report["registers"],
        "spill_bytes": report["spill_bytes"]}


# ---------------------------------------------------------------- K1

K1_SHAPE = (32, 8, 128, 2048)     # Hq, Hkv, D, max_len
# The paged tick's short rows: 8 slots of 128-160 cached keys.
TICK_LENGTHS = [128, 132, 136, 140, 145, 150, 155, 160]
K1_CASES = [                      # (name, T, B, cache lengths)
    ("decode_slots", 1, 8, [0, 1, 127, 128, 129, 2047, 1000, 513]),
    ("decode_scalar", 1, 8, 1500),
    ("decode_tick", 1, 8, TICK_LENGTHS),
    ("prefill_128", 128, 8, 0),
    ("prefill_512", 512, 2, [0, 1024]),
]


def _k1_args(torch, dev, gen, t: int, b: int, lens, mode: str) -> tuple:
    """decode_attention_cuda's arguments in a k1_* case: a cache of
    max_len 2048 from `gen`, bf16 or quantized."""
    hq, hkv, d, max_len = K1_SHAPE
    q = torch.randn(b, t, hq, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, max_len, hkv, d, generator=gen, device=dev)
            for _ in range(2))
    cache_len = (torch.tensor(lens, dtype=torch.int32, device=dev)
                 if isinstance(lens, list) else lens)
    if mode == "bf16":
        return q, k.bfloat16(), v.bfloat16(), cache_len
    (k, ks), (v, vs) = _quantized(torch, k, mode), _quantized(torch, v, mode)
    return q, k, v, cache_len, ks, vs, mode == "int4"


def k1_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    hq, hkv, d, max_len = K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    for name, t, b, lens in K1_CASES:
        q, k, v, cache_len = _k1_args(torch, dev, gen, t, b, lens, "bf16")
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
              **results[name],
              **decode_kernel_info(torch, dev, "Bf16", "Contiguous", t, b,
                                   hq, hkv, max_len)})
        del q, k, v, got, want, mask
    return results


# ---------------------------------------------------------------- K2

# The calls K2 serves on llama3_8b (models/decode.py _proj): each of a
# layer's seven projections and the f32 lm_head at decode (8 rows), and
# prefill at 8 x 128 tokens (1024) and a 512-token paged chunk.
K2_CASES = [                 # (name, T, D, F, x dtype)
    ("wq_t8", 8, 4096, 4096, "bf16"), ("wk_t8", 8, 4096, 1024, "bf16"),
    ("wv_t8", 8, 4096, 1024, "bf16"), ("wo_t8", 8, 4096, 4096, "bf16"),
    ("w_gate_t8", 8, 4096, 14336, "bf16"),
    ("w_up_t8", 8, 4096, 14336, "bf16"),
    ("w_down_t8", 8, 14336, 4096, "bf16"),
    ("lm_head_t8", 8, 4096, 128256, "f32"),
    ("w_gate_t1024", 1024, 4096, 14336, "bf16"),
    ("wk_t1024", 1024, 4096, 1024, "bf16"),
    ("lm_head_t1024", 1024, 4096, 128256, "f32"),
    ("w_gate_t512", 512, 4096, 14336, "bf16"),
]
# Weights are timed cold, as a decode step finds them: calls rotate over
# copies that together exceed the 50 MB L2.
K2_ROTATE_BYTES = 128 << 20


def k2_kernel_info(dev, t: int, d: int, f: int, kind: str) -> dict:
    """The body of kernels/int8_matmul.cu a K2 call runs, its token tile
    and splits of D (ops/quant.plan on this card's SM count), and its
    registers and spill bytes from ptxas's report."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.ops import quant

    p = quant.plan(t, d, f, kernels.sm_count(dev), kind == "bf16")
    xt = "13__nv_bfloat16" if kind == "bf16" else "f"
    report = (ptxas_report(p.body) if p.body == "int8_wgmma_kernel"
              else ptxas_report(p.body, f"ILi{p.tokens}E{xt}E"))
    return {"kernel": p.body, "tokens": p.tokens, "splits": p.splits,
            "registers": report["registers"],
            "spill_bytes": report["spill_bytes"],
            "ptxas_serialized_wgmma": report["ptxas_serialized_wgmma"]}


def _k2_inputs(torch, dev, gen, t, d, f, kind) -> tuple:
    """(x, QuantWeights): enough copies of a random [d, f] weight to
    exceed K2_ROTATE_BYTES between two uses of one."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        QuantWeight,
        quantize_weights,
    )

    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
    qw = quantize_weights(
        torch.randn(d, f, generator=gen, device=dev) * d ** -0.5)
    copies = -(-K2_ROTATE_BYTES // (d * f))
    return x, [qw] + [QuantWeight(qw.values.clone(), qw.scales.clone())
                      for _ in range(copies - 1)]


def _rotating(fn, items):
    """A call of fn on the next of `items` each time."""
    state = {"i": 0}

    def call():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return fn(item)
    return call


def k2_times(torch, dev, x, qws) -> dict:
    """K2's device ms and torch.matmul's on the dequantized weight (the
    library call, x's dtype), each over rotating cold copies."""
    from container_engine_accelerators_tpu_torch.ops.quant import (
        dequantize,
        int8_matmul_cuda,
    )

    ms = device_ms(torch, _rotating(lambda qw: int8_matmul_cuda(x, qw), qws))
    deq = [dequantize(qw, x.dtype) for qw in qws]
    library_ms = device_ms(torch, _rotating(lambda w: torch.matmul(x, w),
                                            deq))
    del deq
    return {"ms": ms, "library_ms": library_ms}


def k2_phase(torch, dev) -> dict:
    from container_engine_accelerators_tpu_torch.ops.quant import (
        int8_matmul_cuda,
        int8_matmul_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    results = {}
    for name, t, d, f, kind in K2_CASES:
        x, qws = _k2_inputs(torch, dev, gen, t, d, f, kind)
        qw = qws[0]
        got = int8_matmul_cuda(x, qw)
        torch.cuda.synchronize()
        want = int8_matmul_plain(x, qw)
        err = (got.float() - want.float()).abs().max().item()
        tol = K2_TOL[kind] * want.float().abs().max().item()
        require(err <= tol, f"K2 {name}: max|diff| {err} > {tol}")
        again = int8_matmul_cuda(x, qw)
        require(torch.equal(got, again), f"K2 {name}: bits changed")
        del got, want, again
        info = k2_kernel_info(dev, t, d, f, kind)
        require(info["spill_bytes"] == 0, f"K2 {name} spills: {info}")
        times = k2_times(torch, dev, x, qws)
        plain_ms = device_ms(torch, lambda: int8_matmul_plain(x, qw),
                             iters=5)
        item = x.element_size()
        n_bytes = t * d * item + d * f + 4 * f + t * f * item
        # One product at the bf16 tensor-core rate, f32 x too: the kernel
        # runs f32 x as two bf16 products (its own floor is twice this).
        bms, by = bound_ms(n_bytes, 2 * t * d * f, "bf16")
        results[name] = {"max_abs_err": err, **times, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by}
        emit({"phase": f"k2_{name}", "T": t, "D": d, "F": f,
              "x_dtype": kind, "tol": tol, **results[name],
              "share_of_bound": bms / times["ms"],
              "over_library": times["ms"] / times["library_ms"], **info})
        del x, qws, qw
    return results


# ---------------------------------------------------------------- K3

K3_SHAPE = (32, 8, 128, 128, 16)  # Hq, Hkv, D, page, max_pages
K3_CASES = [                      # (name, T, cache lengths)
    ("decode", 1, [0, 1, 127, 128, 129, 2047, 1000, 513]),
    ("decode_tick", 1, TICK_LENGTHS),
    ("prefill_chunk_512", 512, [512]),
    ("prefix_suffix_128", 128, [256]),
]


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


def _k3_args(torch, dev, gen, t: int, lens: list, mode: str) -> tuple:
    """paged_decode_attention_cuda's arguments in a k3_* case."""
    hq, hkv, d, page, max_pages = K3_SHAPE
    k_pool, v_pool, tables = _page_pool(torch, dev, gen, lens, t, page,
                                        max_pages, hkv, d)
    q = torch.randn(len(lens), t, hq, d, generator=gen,
                    device=dev).bfloat16()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    if mode == "bf16":
        return q, k_pool, v_pool, lens_t, tables
    (kp, ksp), (vp, vsp) = (_quantized(torch, x.float(), mode)
                            for x in (k_pool, v_pool))
    return q, kp, vp, lens_t, tables, ksp, vsp, mode == "int4"


def k3_phase(torch, dev) -> dict:
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        paged_decode_attention_cuda,
        paged_decode_attention_plain,
    )

    hq, hkv, d, page, max_pages = K3_SHAPE
    max_len = page * max_pages
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    results = {}
    for name, t, lens in K3_CASES:
        b = len(lens)
        q, k_pool, v_pool, lens_t, tables = _k3_args(torch, dev, gen, t,
                                                     lens, "bf16")
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
              **results[name],
              **decode_kernel_info(torch, dev, "Bf16", "Paged", t, b, hq,
                                   hkv, max_len)})
        del q, k, v, k_pool, v_pool, got, want, mask
    return results


# ------------------------------------------------- K1, K3 on int8/int4 KV

def _quantized(torch, x, mode: str):
    """(payload, contiguous head-major scales) of a cache, as the port's
    decode step writes it."""
    from container_engine_accelerators_tpu_torch.ops import quant

    fn = quant.quantize_kv_int4 if mode == "int4" else quant.quantize_kv
    payload, scales = fn(x)
    return payload, scales.contiguous()


def _dequantized(torch, payload, scales, mode: str):
    """The same cache dequantized to bf16 (the inputs of the bf16 kernel
    and of SDPA, for timing)."""
    from container_engine_accelerators_tpu_torch.ops import quant

    fn = quant.dequantize_kv_int4 if mode == "int4" else quant.dequantize_kv
    return fn(payload, scales, torch.bfloat16)


def _quant_case_result(torch, got, want, d, what, kernel, plain, bf16_kernel,
                       library, n_bytes, flops) -> dict:
    err, rel = _row_errors(got, want, d, what)
    bms, by = bound_ms(n_bytes, flops, "bf16")
    return {"max_abs_err": err, "max_row_rel_err": rel,
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, plain, iters=5),
            "bf16_kernel_ms": device_ms(torch, bf16_kernel),
            "library_ms": device_ms(torch, library, iters=5),
            "library": "dequantize to bf16 + SDPA",
            "bound_ms": bms, "bound_by": by}


def k1_quant_phase(torch, dev, mode: str) -> dict:
    """K1's cases on an int8 or int4 cache."""
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        decode_attention_cuda,
        decode_attention_plain,
    )

    hq, hkv, d, max_len = K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    results = {}
    for name, t, b, lens in K1_CASES:
        args = _k1_args(torch, dev, gen, t, b, lens, mode)
        q, k, v, cache_len, ks, vs, _ = args
        got = decode_attention_cuda(*args)
        torch.cuda.synchronize()
        want = decode_attention_plain(*args)
        lens_b = (torch.as_tensor(lens, device=dev).reshape(-1)
                  .expand(b).long())
        n_bytes, flops, mask = _attention_work(torch, lens_b, t, max_len, b,
                                               hq, hkv, d, mode)
        k_bf = _dequantized(torch, k, ks, mode)
        v_bf = _dequantized(torch, v, vs, mode)
        sdpa = _sdpa(F, q, k_bf, v_bf, mask)
        res = _quant_case_result(
            torch, got, want, d, f"K1 {mode} {name}",
            lambda: decode_attention_cuda(*args),
            lambda: decode_attention_plain(*args),
            lambda: decode_attention_cuda(q, k_bf, v_bf, cache_len),
            lambda: (_dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), sdpa()),
            n_bytes, flops)
        results[name] = res
        emit({"phase": f"k1_{mode}_{name}", "T": t, "B": b, "Hq": hq,
              "Hkv": hkv, "D": d, "max_len": max_len, "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL, **res,
              **decode_kernel_info(torch, dev, mode.capitalize(),
                                   "Contiguous", t, b, hq, hkv, max_len)})
        del q, k, v, ks, vs, k_bf, v_bf, got, want, mask, sdpa, args
    return results


def k3_quant_phase(torch, dev, mode: str) -> dict:
    """K3's cases on an int8 or int4 page pool (the k3_* pools,
    quantized); the library yardstick runs on a contiguous copy."""
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops.decode_attention import (
        paged_decode_attention_cuda,
        paged_decode_attention_plain,
    )

    hq, hkv, d, page, max_pages = K3_SHAPE
    max_len = page * max_pages
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    results = {}
    for name, t, lens in K3_CASES:
        b = len(lens)
        args = _k3_args(torch, dev, gen, t, lens, mode)
        q, kp, vp, lens_t, tables, ksp, vsp, _ = args
        got = paged_decode_attention_cuda(*args)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(*args)
        kp_bf = _dequantized(torch, kp, ksp, mode)
        vp_bf = _dequantized(torch, vp, vsp, mode)
        rows = tables.long().clamp(0, kp.shape[0] - 1)
        k = kp[rows].reshape(b, max_len, hkv, -1).contiguous()
        v = vp[rows].reshape(b, max_len, hkv, -1).contiguous()
        ks = ksp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
        vs = vsp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
        n_bytes, flops, mask = _attention_work(torch, lens_t.long(), t,
                                               max_len, b, hq, hkv, d, mode)
        n_bytes += tables.numel() * 4 + lens_t.numel() * 4
        sdpa = _sdpa(F, q, _dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), mask)
        res = _quant_case_result(
            torch, got, want, d, f"K3 {mode} {name}",
            lambda: paged_decode_attention_cuda(*args),
            lambda: paged_decode_attention_plain(*args),
            lambda: paged_decode_attention_cuda(q, kp_bf, vp_bf, lens_t,
                                                tables),
            lambda: (_dequantized(torch, k, ks, mode),
                     _dequantized(torch, v, vs, mode), sdpa()),
            n_bytes, flops)
        res["library"] = "dequantize to bf16 + SDPA, on a contiguous copy"
        results[name] = res
        emit({"phase": f"k3_{mode}_{name}", "T": t, "slots": b, "Hq": hq,
              "Hkv": hkv, "D": d, "page": page, "max_pages": max_pages,
              "n_pages": kp.shape[0], "lengths": lens,
              "row_rtol": K1_ROW_RTOL, "row_atol": K1_ROW_ATOL, **res,
              **decode_kernel_info(torch, dev, mode.capitalize(), "Paged", t,
                                   b, hq, hkv, max_len)})
        del q, kp, vp, ksp, vsp, kp_bf, vp_bf, k, v, ks, vs, got, want
        del mask, sdpa, args
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


def profile_steps(torch, step, steps: int = 4, top: int = 6) -> dict:
    """Device time of `steps` calls of step() by kernel, from
    torch.profiler: the busy time per step, the `top` kernels that take
    most of it, and the device-side spans of record_function ranges
    (the optimizer's step, for one), which cover kernels counted on
    their own and so are kept out of the busy time. None where the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if getattr(e, "is_user_annotation", False)]
    kernels = {}
    for e in device:
        if e not in spans:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / steps / 1e3)
    if not sum(kernels.values()):
        return {"busy_ms_per_step": None, "top": None, "spans": None,
                "kernels": None}
    # Names cut to 60 characters, summed: many kernels share a prefix.
    short: dict = {}
    for name, ms in kernels.items():
        short[name[:60]] = short.get(name[:60], 0.0) + ms
    return {"busy_ms_per_step": sum(kernels.values()),
            "top": dict(sorted(short.items(), key=lambda kv: -kv[1])[:top]),
            "spans": {e.key[:60]: e.device_time_total / steps / 1e3
                      for e in spans},
            "kernels": kernels}


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


# K2's kernels as torch.profiler names them: this checkout's two bodies
# and an older checkout's int8_matmul_partial/_finish.
K2_KERNELS = ("int8_mma_kernel", "int8_wgmma_kernel", "int8_matmul")


def k2_ms(profile: dict) -> float | None:
    """The device ms of K2's kernels in a profile_steps result."""
    if profile["kernels"] is None:
        return None
    return sum(ms for name, ms in profile["kernels"].items()
               if any(k in name for k in K2_KERNELS))


def model_step_profile(torch, dev, decode, model, cfg, batch) -> dict:
    """torch.profiler over a prefill of `batch` from an empty cache
    (decode_step) and over decode steps after it (profile_decode): the
    device-busy ms of each, their top kernels, and K2's ms of each."""
    cache = decode.init_cache(cfg, batch.shape[0], batch.shape[1], dev)

    def prefill():
        decode.decode_step(model, cache, batch, cfg)

    prefill()
    pre = profile_steps(torch, prefill, steps=2)
    dec = profile_decode(torch, dev, decode, model, cfg, batch)
    return {"prefill_device_busy_ms": pre["busy_ms_per_step"],
            "prefill_k2_ms": k2_ms(pre),
            "prefill_top_kernels_ms": pre["top"],
            "decode_device_busy_ms_per_step": dec["busy_ms_per_step"],
            "decode_k2_ms_per_step": k2_ms(dec),
            "decode_top_kernels_ms_per_step": dec["top"]}


def int8_timing(torch, dev, model, qmodel, cfg, batch) -> dict:
    """The bf16 weights and their int8 copy on the same batch: prefill
    and decode-step wall ms (generate), and model_step_profile's
    device-busy ms and top kernels of each."""
    from container_engine_accelerators_tpu_torch.models import decode

    res = {}
    for name, m in (("bf16", model), ("int8", qmodel)):
        prefill_ms, step_ms = step_times_ms(torch, decode.generate, m, batch,
                                            cfg)
        res[name] = {"prefill_ms_b8_t128": prefill_ms,
                     "decode_ms_per_step_b8": step_ms,
                     **model_step_profile(torch, dev, decode, m, cfg, batch)}
    res["int8_prefill_over_bf16"] = (res["int8"]["prefill_ms_b8_t128"]
                                     / res["bf16"]["prefill_ms_b8_t128"])
    return res


def _int8_batch(torch, dev, np, cfg):
    rs = np.random.RandomState(SEED + 2)
    return torch.tensor(rs.randint(0, cfg.vocab_size, size=(8, 128)),
                        device=dev)


def int8_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops.quant import (
        quantize_llama_params,
    )

    qmodel = quantize_llama_params(model)
    batch = _int8_batch(torch, dev, np, cfg)
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
    timing = int8_timing(torch, dev, model, qmodel, cfg, batch)
    result = {"phase": "int8", "model": "llama3_8b", "batch": 8,
              "prompt": 128, "new_tokens": 16, "launches": launches,
              "prefill_logits_max_abs_diff": diff,
              "prefill_logits_max_abs": scale,
              "prefill_ms_b8_t128": timing["int8"]["prefill_ms_b8_t128"],
              "decode_ms_per_step_b8":
                  timing["int8"]["decode_ms_per_step_b8"],
              **timing}
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
    around `ticks` ticks, the kernel launches per tick, and the
    torch.profiler breakdown of 4 more."""
    from container_engine_accelerators_tpu_torch import kernels
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
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ticks):
        tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    per_tick = {name: n / ticks for name, n in kernels.launches.items()}
    profile = profile_steps(torch, tick)
    busy = profile["busy_ms_per_step"]
    return {"paged_decode_tick_ms_8_slots": tick_ms,
            "launches_per_tick": per_tick,
            "tick_cache_lengths": [128 + 4, 128 + 4 + ticks + 4],
            "device_busy_ms_per_tick": busy,
            "device_idle_share": None if busy is None else 1 - busy / tick_ms,
            "top_kernels_ms_per_tick": profile["top"]}


def _paged_requests(np, cfg) -> tuple[dict, list, list]:
    """(warm-up, prefix hits, burst) of the paged phase: the warm-up
    leaves a 256-token prefix in the prefix cache, the burst holds 8
    short requests, 3 that share the prefix, 2 streamed and, last (so
    the slots they join are decoding), 2 of 1024 tokens."""
    prompt = _prompts(np, cfg, SEED + 3)
    prefix = prompt(256)
    warm = {"tokens": prefix + prompt(128), "max_new_tokens": 16}
    hits = [{"tokens": prefix + prompt(128), "max_new_tokens": 16}
            for _ in range(3)]
    requests = ([{"tokens": prompt(128), "max_new_tokens": 32}
                 for _ in range(8)] + hits
                + [{"tokens": prompt(64), "max_new_tokens": 16,
                    "stream": True} for _ in range(2)]
                + [{"tokens": prompt(1024), "max_new_tokens": 16}
                   for _ in range(2)])
    return warm, hits, requests


def paged_engine(model, cfg):
    """The paged phase's engine: 8 slots, max_len 2048, page 128, the
    default pool of 65 pages, prefix cap 256, chunk 512."""
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    return PagedContinuousEngine(model, cfg, max_slots=8, max_len=2048,
                                 page=128, prefix_cap=256, prefill_chunk=512,
                                 engine_core="async")


def paged_burst(torch, np, engine, cfg, what: str) -> tuple[dict, list]:
    """The paged phase's warm-up and burst behind make_server on
    `engine`: answers checked, no page leaked. (result, burst answers)."""
    from container_engine_accelerators_tpu_torch import kernels

    warm, _, requests = _paged_requests(np, cfg)
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
                  cfg.vocab_size, f"{what} warm-up")
    generated = _check_burst(requests, answers, cfg.vocab_size, what)
    require(health["requests"] == 1 + len(requests) and
            health["worker_alive"], f"{what}: healthz {health}")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            f"{what}: leaked pages: {engine.pages_in_use} in use, "
            f"{engine.prefix_index.pages_held()} held by the prefix index")
    return {"model": "llama3_8b", "max_slots": 8, "max_len": 2048,
            "page": 128, "pool_pages": engine.pool_pages,
            "prefill_chunk": 512, "requests": 1 + len(requests),
            "burst_requests": len(requests), "burst_s": t_end - t_start,
            "generated_tokens_per_s": generated / (t_end - t_start),
            "stream_ttft_s": _stream_ttft_s(requests, answers),
            "decode_steps": health["batches"],
            "no_page_leaked": True,
            "max_memory_allocated_bytes": peak,
            "launches": launches}, answers


def paged_phase(torch, dev, np, model, cfg) -> dict:
    from container_engine_accelerators_tpu_torch.models import decode

    _, hits, _ = _paged_requests(np, cfg)
    engine = paged_engine(model, cfg)
    # Every prefill chunk as (request id, start, new_len, steps_run).
    chunks = []
    run_chunk = engine._run_chunk

    def logged_chunk(slot, tokens, start, new_len):
        chunks.append((engine._slots[slot]["rid"], start, new_len,
                       engine.steps_run))
        return run_chunk(slot, tokens, start, new_len)

    engine._run_chunk = logged_chunk
    served, answers = paged_burst(torch, np, engine, cfg, "paged")
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
    require(served["launches"].get("paged_decode_attention", 0) > 0,
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
        "phase": "paged", **served, **counters,
        "long_prompt_chunks": split,
        "prefix_hit_tokens_matching_generate": [f"{m}/16" for m in matches],
        **paged_tick(torch, dev, np, model, cfg),
    }
    emit(result)
    return result


def preempt_run(torch, np, model, cfg, pool_pages: int) -> dict:
    """paged_preempt's load, 3 slots and 3 x 200 / 250 tokens, on a pool
    of `pool_pages` pages (the trash row included): answers checked, no
    page leaked, and the preemptions it took."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli.serve import (
        PagedContinuousEngine,
    )

    prompt = _prompts(np, cfg, SEED + 6)
    n_new = 250
    prompts = [prompt(200) for _ in range(3)]
    engine = PagedContinuousEngine(model, cfg, max_slots=3, max_len=2048,
                                   page=128, pool_pages=pool_pages,
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
    require(engine.requests_served == 3, "not every request finished")
    require(engine.pages_in_use == engine.prefix_index.pages_held(),
            "leaked pages after preemption")
    return {"max_slots": 3, "pool_pages": pool_pages, "prompt": 200,
            "new_tokens": n_new, "preemptions": engine.preemptions,
            "prefills_run": engine.prefills_run, "seconds": seconds,
            "generated_tokens_per_s": 3 * n_new / seconds,
            "launches": launches}


def paged_preempt_phase(torch, dev, np, model, cfg) -> dict:
    # 8 usable pages; each request grows to 450 tokens, 4 pages: 12.
    result = {"phase": "paged_preempt",
              **preempt_run(torch, np, model, cfg, PREEMPT_POOL_PAGES["bf16"])}
    require(result["preemptions"] > 0, "no request was preempted")
    require(result["launches"].get("paged_decode_attention", 0) > 0,
            "preempt path launched no paged_decode_attention kernel")
    emit(result)
    return result


def continuous_burst(torch, np, model, cfg) -> dict:
    """ContinuousEngine (8 slots, max_len 2048, chunk 512) behind
    make_server on 8 x 128 / 32 and 2 streamed 64 / 16: answers checked."""
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
    return {"model": "llama3_8b", "max_slots": 8, "max_len": 2048,
            "requests": len(requests), "burst_s": t_end - t_start,
            "generated_tokens_per_s": generated / (t_end - t_start),
            "stream_ttft_s": _stream_ttft_s(requests, answers),
            "decode_steps": health["batches"],
            "max_memory_allocated_bytes": peak, "launches": launches}


def continuous_phase(torch, dev, np, model, cfg) -> dict:
    result = {"phase": "continuous",
              **continuous_burst(torch, np, model, cfg)}
    require(result["launches"].get("decode_attention", 0) > 0,
            "continuous path launched no decode_attention kernel")
    emit(result)
    return result


def _cache_bytes_per_token(torch, dev, cfg) -> float:
    """Bytes of the tensors init_paged_cache allocates in cfg's layout,
    over the tokens they hold."""
    from container_engine_accelerators_tpu_torch.models import decode

    n_pages, page = 2, 128
    cache = decode.init_paged_cache(cfg, 1, n_pages, page, 1, dev)
    tensors = (cache.k_pool, cache.v_pool, cache.k_scales, cache.v_scales)
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None) / (n_pages * page)


def _quant_logits(torch, dev, np, model, cfgs) -> dict:
    """Per mode: one decode step after a 128-token prefill, on the kernel
    path and on the plain path over two copies of the same quantized
    cache (held within LOGITS_RTOL); and the prefill logits' drift from
    the bf16 cache's (reported, not held: random weights set no
    contract)."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import decode

    rs = np.random.RandomState(SEED + 12)
    prompt = torch.tensor(
        [rs.randint(0, cfgs["bf16"].vocab_size, size=128).tolist()],
        device=dev)
    prefill, out = {}, {}
    for mode, cfg in cfgs.items():
        cache = decode.init_cache(cfg, 1, 160, dev)
        prefill[mode], cache = decode.decode_step(model, cache, prompt, cfg)
        if mode == "bf16":
            continue
        twin = dataclasses.replace(
            cache, **{name: getattr(cache, name).clone()
                      for name in ("k", "v", "k_scales", "v_scales")})
        tok = prefill[mode][:, -1:].argmax(-1)
        kern, _ = decode.decode_step(model, cache, tok, cfg)
        plain, _ = decode.decode_step(model, twin, tok, cfg, plain=True)
        diff = (kern - plain).abs().max().item()
        scale = plain.abs().max().item()
        require(diff <= LOGITS_RTOL * scale,
                f"kv_quant {mode}: decode logits kernel vs plain {diff} > "
                f"{LOGITS_RTOL} * {scale}")
        ref = prefill["bf16"]
        out[mode] = {
            "decode_logits_max_abs_diff_kernel_vs_plain": diff,
            "decode_logits_max_abs": scale,
            "prefill_logits_max_abs_diff_vs_bf16":
                (prefill[mode] - ref).abs().max().item(),
            "prefill_logits_rel_mse_vs_bf16":
                ((prefill[mode] - ref) ** 2).mean().item()
                / (ref ** 2).mean().item(),
            "last_token_argmax_equals_bf16": bool(
                prefill[mode][0, -1].argmax() == ref[0, -1].argmax())}
        del cache, twin, kern, plain
    return out


def kv_quant_phase(torch, dev, np, model, cfg, preempt_bf16) -> dict:
    """The serving engines on int8 and int4 KV caches (see the module
    docstring). Main-path launches: the paged bursts, the preemption
    runs and the continuous bursts."""
    import dataclasses

    cfgs = {mode: dataclasses.replace(cfg, kv_cache_dtype=mode)
            for mode in ("bf16",) + KV_MODES}
    per_token = {mode: _cache_bytes_per_token(torch, dev, c)
                 for mode, c in cfgs.items()}
    require(per_token == KV_BYTES_PER_TOKEN,
            f"cache bytes per token {per_token}, want {KV_BYTES_PER_TOKEN}")
    pool_bytes = {mode: PREEMPT_POOL_PAGES[mode] * 128 * per_token[mode]
                  for mode in cfgs}
    result = {"phase": "kv_quant", "model": "llama3_8b",
              "cache_bytes_per_token": per_token,
              "preempt_pool_pages": PREEMPT_POOL_PAGES,
              "preempt_pool_bytes": pool_bytes,
              "logits": _quant_logits(torch, dev, np, model, cfgs)}
    launches: dict = {}
    preemptions = {"bf16": preempt_bf16["preemptions"]}
    for mode in KV_MODES:
        c = cfgs[mode]
        require(pool_bytes[mode] <= pool_bytes["bf16"],
                f"{mode} pool larger than bf16's")
        paged, _ = paged_burst(torch, np, paged_engine(model, c), c,
                               f"kv_quant {mode} paged")
        tick = paged_tick(torch, dev, np, model, c)
        per_tick = tick["launches_per_tick"].get(
            f"paged_decode_attention_{mode}")
        require(per_tick == c.n_layers,
                f"{mode} paged tick: {per_tick} K3 launches, want "
                f"{c.n_layers}")
        preempt = preempt_run(torch, np, model, c, PREEMPT_POOL_PAGES[mode])
        preemptions[mode] = preempt["preemptions"]
        cont = continuous_burst(torch, np, model, c)
        for run, name in ((paged, f"paged_decode_attention_{mode}"),
                          (preempt, f"paged_decode_attention_{mode}"),
                          (cont, f"decode_attention_{mode}")):
            require(run["launches"].get(name, 0) > 0,
                    f"kv_quant {mode}: a run launched no {name}")
            for key, n in run["launches"].items():
                launches[key] = launches.get(key, 0) + n
        result[mode] = {"paged": {**paged, **tick}, "preempt": preempt,
                        "continuous": cont}
    result["preemptions_same_pool_bytes"] = preemptions
    result["launches"] = launches
    emit(result)
    return result


# ---------------------------------------------------------------- K4-K6

def ptxas_report(kernel: str, *parts: str) -> dict:
    """Registers and spill bytes of a kernel function (the first whose
    mangled name holds `kernel` and every one of `parts`), from ptxas's
    -v report in the build log of the library that kernels.load() loaded
    (the launch's register count: a warp-specialised kernel moves
    registers between its warpgroups with setmaxnreg from there)."""
    from container_engine_accelerators_tpu_torch import kernels

    path = kernels.build_log()
    require(path.exists(), f"no build log {path.name} beside the library")
    log = path.read_text()
    for block in log.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        if not all(part in name for part in (kernel, *parts)):
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        require(regs is not None and spill is not None,
                f"no ptxas report for {kernel} in {path.name}")
        # ptxas names the function on a line of its own where it had to
        # serialize wgmma products (C7514, C7520).
        serialized = any("serialized" in line and kernel in line
                         for line in log.splitlines())
        return {"registers": int(regs.group(1)),
                "spill_bytes": int(spill.group(1)) + int(spill.group(2)),
                "ptxas_serialized_wgmma": serialized}
    raise SmokeFailure(f"{kernel} {parts} is not in {path.name}")


def _sdpa_backend(torch, q, k, v, kw: dict) -> str:
    """The backend SDPA's dispatcher picks for these inputs and keywords
    (torch._fused_sdp_choice, a private call; "unknown" without it)."""
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, kw.get("attn_mask"), 0.0, kw.get("is_causal", False),
            scale=kw.get("scale"), enable_gqa=kw.get("enable_gqa", False))
        ).name
    except (AttributeError, TypeError, ValueError, RuntimeError):
        return "unknown"


def _flash_work(torch, seg, b, s, hq, hkv, d, causal) -> dict:
    """Bytes each kernel must move and operations it must do on these
    inputs: each input read once, each output written once; 4, 6 and 8
    flops per (visible query-key pair, head dim) for K4, K5 and K6 (the
    forward's two products; dq's three; dk/dv's four)."""
    if seg is None:
        pairs = b * (s * (s + 1) // 2 if causal else s * s)
    else:
        vis = seg[:, :, None] == seg[:, None, :]
        if causal:
            vis &= torch.ones(s, s, dtype=torch.bool,
                              device=seg.device).tril()
        pairs = int(vis.sum().item())
    qb, kvb = 2 * b * s * hq * d, 2 * b * s * hkv * d
    stat, segb = 4 * b * hq * s, 0 if seg is None else 4 * b * s
    per_pair = d * hq * pairs
    return {"flash_fwd": (2 * qb + 2 * kvb + stat + segb, 4 * per_pair),
            "flash_bwd_dq": (3 * qb + 2 * kvb + 2 * stat + segb,
                             6 * per_pair),
            "flash_bwd_dkv": (2 * qb + 4 * kvb + 2 * stat + segb,
                              8 * per_pair),
            "visible_pairs": pairs}


def _flash_cases(torch, dev, b: int, s: int, hq: int = 32, hkv: int = 8):
    """flash_phase's cases, (case, causal, seg, q, k, v, do) each, on
    inputs from a seed: q pre-scaled, head_dim 128, bf16."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    pos = torch.arange(s, device=dev)
    packed = ((pos >= s // 3).float() + (pos >= 3 * s // 4).float()).expand(
        b, s).contiguous()    # three packed sequences per row

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    for case, causal, seg in [("main", True, None),
                              ("segmented", True, packed),
                              ("noncausal", False, None)]:
        q = fa._prescale(rnd(b, s, hq, 128))
        k, v = rnd(b, s, hkv, 128), rnd(b, s, hkv, 128)
        do = rnd(b, s, hq, 128)
        yield case, causal, seg, q, k, v, do


def _flash_sdpa(torch, q, k, v, seg, causal):
    """One PyTorch call for the flash kernels' attention (timing only;
    the port never calls it): (SDPA with its keywords, q, k and v in its
    layout, requiring grad). Segmented, SDPA takes the segment-and-causal boolean
    mask, and the KV heads are repeated, so that a backend that takes a
    mask but not GQA may run."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    if seg is None:
        return (functools.partial(F.scaled_dot_product_attention,
                                  is_causal=causal, scale=1.0,
                                  enable_gqa=True), qt, kt, vt)
    n_rep, s = q.shape[2] // k.shape[2], q.shape[1]
    kt, vt = (x.detach().repeat_interleave(n_rep, dim=1).requires_grad_()
              for x in (kt, vt))
    vis = (seg[:, :, None] == seg[:, None, :])[:, None]
    if causal:
        vis = vis & torch.ones(s, s, dtype=torch.bool,
                               device=q.device).tril()
    return (functools.partial(F.scaled_dot_product_attention,
                              attn_mask=vis, scale=1.0), qt, kt, vt)


def _sdpa_times(torch, q, k, v, seg, causal, do) -> dict:
    """SDPA's forward and its backward timed two ways (timing only): dq,
    dk and dv in one call, and with only q requiring grad (K5's function:
    whether the backend then computes dq alone shows in the ratio of the
    two); and the backend SDPA's dispatcher picks."""
    sdpa, qt, kt, vt = _flash_sdpa(torch, q, k, v, seg, causal)
    dot = do.transpose(1, 2)
    o = sdpa(qt, kt, vt)
    o_q = sdpa(qt, kt.detach(), vt.detach())
    res = {
        "sdpa_backward_ms": device_ms(
            torch, lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                               retain_graph=True), iters=10),
        "sdpa_backward_dq_only_ms": device_ms(
            torch, lambda: torch.autograd.grad(o_q, (qt,), dot,
                                               retain_graph=True), iters=10),
        "sdpa_backend": _sdpa_backend(torch, qt, kt, vt, sdpa.keywords),
        "sdpa_forward_ms": device_ms(
            torch, functools.partial(sdpa, qt.detach(), kt.detach(),
                                     vt.detach()), iters=10)}
    res["sdpa_dq_only_share"] = (res["sdpa_backward_dq_only_ms"]
                                 / res["sdpa_backward_ms"])
    return res


def flash_phase(torch, dev, b: int = 4, s: int = 2048, hq: int = 32,
                hkv: int = 8) -> dict:
    """K4, K5 and K6 against their plain versions at the train phase's
    attention shapes; the backward kernels take the plain forward's out
    and lse, so each is held alone. Returns {kernel: {case: result}}."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    d = 128
    results = {name: {} for name in FLASH_REPLACES}
    ptxas = {name: ptxas_report(f"{name}_kernel") for name in FLASH_REPLACES}
    for name, report in ptxas.items():
        require(report["spill_bytes"] == 0, f"{name} spills: {report}")
    for case, causal, seg, q, k, v, do in _flash_cases(torch, dev, b, s, hq,
                                                       hkv):
        work = _flash_work(torch, seg, b, s, hq, hkv, d, causal)
        out, lse = fa.flash_fwd_cuda(q, k, v, seg, causal)
        torch.cuda.synchronize()
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, causal)
        delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, seg, do, lse_p, delta.contiguous(), causal)
        dq = fa.flash_bwd_dq_cuda(*args)
        dk, dv = fa.flash_bwd_dkv_cuda(*args)
        torch.cuda.synchronize()
        dq_p = fa.flash_bwd_dq_plain(*args)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(*args)
        lse_err = (lse - lse_p).abs().max().item()
        require(lse_err <= LSE_ATOL, f"K4 {case}: lse off by {lse_err}")
        def held(got, want, what, rtol=FLASH_GRAD_ROW_RTOL):
            atol = FLASH_TENSOR_ATOL * want.float().abs().max().item()
            return _row_errors(got, want, d, what, rtol=rtol, atol=atol)

        errs = {"flash_fwd": [held(out, out_p, f"K4 {case}", K1_ROW_RTOL)],
                "flash_bwd_dq": [held(dq, dq_p, f"K5 {case}")],
                "flash_bwd_dkv": [held(dk, dk_p, f"K6 {case} dk"),
                                  held(dv, dv_p, f"K6 {case} dv")]}
        del out, out_p, dq, dq_p, dk, dk_p, dv, dv_p
        timed = {
            "flash_fwd": (lambda: fa.flash_fwd_cuda(q, k, v, seg, causal),
                          lambda: fa.flash_fwd_plain(q, k, v, seg, causal)),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq_cuda(*args),
                             lambda: fa.flash_bwd_dq_plain(*args)),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv_cuda(*args),
                              lambda: fa.flash_bwd_dkv_plain(*args)),
        }
        # SDPA's forward for K4; its backward with only q requiring grad
        # for K5, and dq, dk and dv in one call for K6.
        sdpa = _sdpa_times(torch, q, k, v, seg, causal, do)
        library = {"flash_fwd": sdpa["sdpa_forward_ms"],
                   "flash_bwd_dq": sdpa["sdpa_backward_dq_only_ms"],
                   "flash_bwd_dkv": sdpa["sdpa_backward_ms"]}
        what = {"flash_fwd": "SDPA forward",
                "flash_bwd_dq": "SDPA backward, only q requiring grad",
                "flash_bwd_dkv": "SDPA backward: dq, dk and dv in one call"}
        prefix = {"flash_fwd": "k4", "flash_bwd_dq": "k5",
                  "flash_bwd_dkv": "k6"}
        for name, (kernel, plain) in timed.items():
            n_bytes, flops = work[name]
            bms, by = bound_ms(n_bytes, flops, "bf16")
            res = {"max_abs_err": max(e[0] for e in errs[name]),
                   "max_row_rel_err": max(e[1] for e in errs[name]),
                   "ms": device_ms(torch, kernel),
                   "plain_ms": device_ms(torch, plain, iters=3),
                   "library_ms": library[name],
                   "bound_ms": bms, "bound_by": by, **ptxas[name]}
            res["library"] = (what[name]
                              + ("" if seg is None else
                                 ", boolean mask, KV heads repeated")
                              + f", {sdpa['sdpa_backend']} backend")
            results[name][case] = res
            emit({"phase": f"{prefix[name]}_{case}", "B": b, "S": s,
                  "Hq": hq, "Hkv": hkv, "D": d, "causal": causal,
                  "visible_pairs": work["visible_pairs"],
                  "row_rtol": (K1_ROW_RTOL if name == "flash_fwd"
                               else FLASH_GRAD_ROW_RTOL),
                  "tensor_atol_share": FLASH_TENSOR_ATOL,
                  "lse_max_abs_err": lse_err, **res})
        # The backward pair against SDPA's whole backward: K5 and K6 do
        # seven products where a fused backward does five, the price of
        # summing dq without atomics.
        pair = (results["flash_bwd_dq"][case]["ms"]
                + results["flash_bwd_dkv"][case]["ms"])
        emit({"phase": f"k5_k6_{case}", "pair_ms": pair,
              "pair_bound_ms": (results["flash_bwd_dq"][case]["bound_ms"]
                                + results["flash_bwd_dkv"][case]["bound_ms"]),
              "sdpa_backward_ms": sdpa["sdpa_backward_ms"],
              "pair_over_sdpa": pair / sdpa["sdpa_backward_ms"],
              "sdpa_dq_only_share": sdpa["sdpa_dq_only_share"]})
        del q, k, v, do, lse, lse_p, delta, args, timed
    return results


# ---------------------------------------------------------------- train

def train_phase(torch, dev, np, n_layers: int = 8, batch: int = 4,
                seq: int = 2048, steps: int = 6) -> dict:
    """fit() on llama3_8b widths at `n_layers` layers from seed 0 for
    `steps` steps, logging every step: the loss fetch at each log is a
    device fence, so the gaps between logs are device-synchronised step
    times, and the launch counts between logs are one step's."""
    import re

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
        make_train_step,
        to_device,
    )

    cfg = llama3_8b(n_layers=n_layers)
    batches = synthetic_batches(cfg.vocab_size, batch, seq, seed=SEED)
    logs = []

    def log_fn(msg):
        logs.append((time.perf_counter(), msg, dict(kernels.launches)))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, _ = fit(cfg, make_optimizer(), batches, device=dev,
                   max_steps=steps, seed=SEED, log_every=1, log_fn=log_fn)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launches)
    require(state.step == steps and len(logs) == steps,
            f"fit ran {state.step} steps, logged {len(logs)}")
    losses = [float(re.search(r"loss (\S+)", m).group(1))
              for _, m, _ in logs]
    gnorms = [float(re.search(r"grad_norm (\S+)", m).group(1))
              for _, m, _ in logs]
    require(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
            f"train: non-finite loss or grad norm {losses} {gnorms}")
    per_step, prev = [], {}
    for _, _, counts in logs:
        per_step.append({name: counts.get(name, 0) - prev.get(name, 0)
                         for name in TRAIN_LAUNCHES_PER_STEP})
        prev = counts
    want = TRAIN_LAUNCHES_PER_STEP if n_layers == 8 else {
        name: n * n_layers // 8 for name, n in
        TRAIN_LAUNCHES_PER_STEP.items()}
    require(all(step == want for step in per_step),
            f"train: launches per step {per_step}, want {want}")
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(logs, logs[1:])]
    median_ms = float(np.median(step_ms))
    tokens_per_s = batch * seq / (median_ms / 1e3)
    flops_per_token = cfg.train_flops_per_token(seq)

    step_fn = make_train_step(cfg, state.optimizer)
    extra = to_device(next(batches), dev)
    profile = profile_steps(torch, lambda: step_fn(state.model, extra),
                            steps=1, top=12)
    busy = profile["busy_ms_per_step"]
    by_kind: dict = {}
    for name, ms in (profile["kernels"] or {}).items():
        kind = next((k for k, marks in STEP_KERNEL_KINDS.items()
                     if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    del state, step_fn, extra
    result = {
        "phase": "train", "model": "llama3_8b", "n_layers": n_layers,
        "params": cfg.num_params(), "batch": batch, "seq": seq,
        "steps": steps, "remat_policy": cfg.remat_policy,
        "fit_s": fit_s, "step_ms_after_first": step_ms,
        "median_step_ms": median_ms, "tokens_per_s": tokens_per_s,
        "train_flops_per_token": flops_per_token,
        "mfu": tokens_per_s * flops_per_token / PEAK_FLOPS["bf16"],
        "device_busy_ms_per_step": busy,
        "device_busy_share": None if busy is None else busy / median_ms,
        "device_ms_per_step_by_kind": by_kind,
        "flash_ms_per_step": {
            name: sum(ms for kernel, ms in (profile["kernels"] or {}).items()
                      if f"{name}_kernel" in kernel)
            for name in FLASH_REPLACES},
        "top_kernels_ms_per_step": profile["top"],
        "spans_ms_per_step": profile["spans"],
        "max_memory_allocated_bytes": peak,
        "losses": losses, "grad_norms": gnorms,
        "launches_per_step": per_step[0], "launches": launches,
    }
    emit(result)
    return result


def train_parity_phase(torch, dev, np, n_layers: int = 2, seq: int = 512
                       ) -> dict:
    """One make_train_step from the same weights and batch: the kernel
    path against the plain path, and the kernel path under three remat
    policies, which must give identical bits."""
    import dataclasses

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_train_params,
        llama3_8b,
    )
    from container_engine_accelerators_tpu_torch.training.data import (
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        make_optimizer,
        make_train_step,
        to_device,
    )

    cfg = llama3_8b(n_layers=n_layers)
    model = init_train_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 9), dev)
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    batch = to_device(next(synthetic_batches(cfg.vocab_size, 1, seq,
                                             seed=SEED + 9)), dev)

    def run(plain, policy):
        with torch.no_grad():
            for p, s in zip(params, start):
                p.copy_(s)
        c = dataclasses.replace(cfg, remat_policy=policy)
        kernels.reset_launches()
        metrics = make_train_step(c, make_optimizer()(params),
                                  plain=plain)(model, batch)
        loss = metrics["loss"].item()
        return loss, [p.grad.detach().clone() for p in params], dict(
            kernels.launches)

    loss_k, grads_k, launches_k = run(False, "dots")
    loss_p, grads_p, launches_p = run(True, "dots")
    require(not launches_p, f"plain path launched {launches_p}")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = max(((gk.float() - gp.float()).norm()
                    / gp.float().norm()).item()
                   for gk, gp in zip(grads_k, grads_p))
    del grads_p
    require(np.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_RTOL,
            f"train_parity: loss {loss_k} vs plain {loss_p}")
    require(grad_rel <= TRAIN_GRAD_RTOL,
            f"train_parity: a gradient is {grad_rel} of its norm off plain")
    identical, remat_launches = {}, {"dots": launches_k}
    for policy in ("none", "full"):
        loss, grads, remat_launches[policy] = run(False, policy)
        identical[policy] = loss == loss_k and all(
            torch.equal(a, b) for a, b in zip(grads, grads_k))
        del grads
    del model, params, start, grads_k
    require(all(identical.values()),
            f"train_parity: remat policies gave other gradients {identical}")
    result = {"phase": "train_parity", "model": "llama3_8b",
              "n_layers": n_layers, "batch": 1, "seq": seq,
              "loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_diff": loss_rel, "max_grad_rel_diff": grad_rel,
              "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
              "remat_identical_to_dots": identical,
              "launches_by_remat": remat_launches}
    emit(result)
    return result


def train_cli_phase() -> dict:
    import io

    from container_engine_accelerators_tpu_torch.cli import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--preset", "tiny", "--steps", "3"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    require(rc == 0 and line["final_step"] == 3 and
            math.isfinite(line["loss"]), f"train cli: {rc} {line}")
    result = {"phase": "train_cli", **line}
    emit(result)
    return result


class RecordingK8s:
    """The health checker's duck-typed Kubernetes client, recording what
    it is asked to write."""

    def __init__(self, node_name: str):
        self.events: list = []
        self.nodes = {node_name: {"metadata": {"name": node_name},
                                  "status": {"conditions": []}}}

    def create_event(self, namespace: str, body: dict) -> None:
        self.events.append(body)

    def set_node_condition(self, node_name: str, cond: dict) -> None:
        conds = self.nodes[node_name]["status"]["conditions"]
        conds[:] = [c for c in conds if c["type"] != cond["type"]] + [cond]

    def get_node(self, node_name: str) -> dict:
        return self.nodes[node_name]


def provoke_all() -> dict:
    """The real-fault runs of demo/real_fault/capture.py, each in a
    process of its own and all at once: name -> (exit code, stderr)."""
    from container_engine_accelerators_tpu_torch.demo.real_fault import (
        capture,
    )

    with concurrent.futures.ThreadPoolExecutor(len(capture.RUNS)) as pool:
        futs = {name: pool.submit(capture.provoke, name, 300)
                for name in capture.RUNS}
        return {name: fut.result() for name, fut in futs.items()}


K7_ROUNDS = 5


def k7_times(torch, x) -> dict:
    """K7 and torch.mul(x, 2.0) timed in turns, K7_ROUNDS each: their
    median device ms and every run's."""
    import statistics

    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo_cuda,
    )

    runs = {"ms": [], "library_ms": []}
    for _ in range(K7_ROUNDS):
        runs["ms"].append(device_ms(torch, lambda: scale_demo_cuda(x)))
        runs["library_ms"].append(device_ms(torch,
                                            lambda: torch.mul(x, 2.0)))
    return {**{key: statistics.median(v) for key, v in runs.items()},
            **{f"{key}_runs": v for key, v in runs.items()}}


def health_phase(torch, dev, tmp_dir: str, shape=(4096, 4096)) -> dict:
    """The node health path on the card. The healthy K7 runs as the
    node's workload (the one launch counted); then K7 built with the
    whole array as one shared-memory tile, an allocation larger than the
    card and a benign bf16 matmul run as processes of their own, their
    stderr is the runtime log, and a TPUHealthChecker over a TPUManager
    of the host's real /dev scrapes it: VMEM_OOM and HBM_OOM counted,
    every device still Healthy. Then cli.inject_fault appends
    HBM_ECC_UNCORRECTABLE for card 0 to the checker's JSONL feed: nvidia0
    turns Unhealthy, with one Warning Event and the node condition. Last,
    K7 against its plain version x * 2.0 (exact) and timed."""
    import io

    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.cli import inject_fault
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        HEALTHY,
        UNHEALTHY,
        SysfsDeviceInfo,
        TPUConfig,
        TPUManager,
    )
    from container_engine_accelerators_tpu_torch.healthcheck import (
        TPUHealthChecker,
    )
    from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (
        NODE_CONDITION_TYPE,
    )
    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo,
        scale_demo_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(shape, generator=g, device=dev)
    runtime_log = os.path.join(tmp_dir, "runtime.log")
    feed = os.path.join(tmp_dir, "errors.jsonl")
    open(feed, "w").close()

    kernels.reset_launches()
    y = scale_demo(x)
    torch.cuda.synchronize()
    runs = provoke_all()
    with open(runtime_log, "w") as f:
        for name in ("smem_oom", "hbm_oom", "benign_success"):
            f.write(runs[name][1])
    cfg = TPUConfig(runtime_log_path=runtime_log)
    cfg.validate()
    manager = TPUManager(cfg, SysfsDeviceInfo())
    manager.discover()
    devices = {d.ID: d.health for d in manager.snapshot()}
    k8s = RecordingK8s("smoke-node")
    checker = TPUHealthChecker(manager, cfg, k8s=k8s,
                               node_name="smoke-node",
                               error_log_path=feed)
    checker.maybe_reset_condition()
    checker.poll_once()
    summary = checker.error_summary()
    health_after_faults = {d.ID: d.health for d in manager.snapshot()}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = inject_fault.main(["--chip", "0",
                                "--error-class", "HBM_ECC_UNCORRECTABLE",
                                "--error-log", feed])
    checker.poll_once()
    launches = dict(kernels.launches)
    health_after_ecc = {d.ID: d.health for d in manager.snapshot()}
    conds = k8s.nodes["smoke-node"]["status"]["conditions"]
    cond = next((c for c in conds if c["type"] == NODE_CONDITION_TYPE), {})

    for name, (code, text) in runs.items():
        require((code != 0) == (name != "benign_success"),
                f"health: {name} exited {code}: {text[-2000:]}")
    require("uses too much shared data" in runs["smem_oom"][1],
            f"health: smem_oom said {runs['smem_oom'][1][-2000:]}")
    require("CUDA out of memory" in runs["hbm_oom"][1],
            f"health: hbm_oom said {runs['hbm_oom'][1][-2000:]}")
    require(len(devices) >= 1, f"health: discovery found {devices}")
    counts = summary["counts"]
    require(counts.get("VMEM_OOM", 0) >= 1 and counts.get("HBM_OOM", 0) >= 1
            and set(counts) == {"VMEM_OOM", "HBM_OOM"}
            and not summary["critical_seen"],
            f"health: the real faults classified as {summary}")
    require(set(health_after_faults.values()) == {HEALTHY},
            f"health: devices after the real faults {health_after_faults}")
    require(rc == 0, f"health: inject_fault exited {rc}")
    backed = {d for d in devices if d == "nvidia0"
              or d.startswith("nvidia0/")}
    require(bool(backed) and all(
        (h == UNHEALTHY) == (d in backed)
        for d, h in health_after_ecc.items()),
        f"health: devices after HBM_ECC_UNCORRECTABLE on card 0 "
        f"{health_after_ecc}")
    warnings = [e for e in k8s.events if e["type"] == "Warning"]
    require(len(warnings) == 1
            and warnings[0]["reason"] == "HBM_ECC_UNCORRECTABLE",
            f"health: events {k8s.events}")
    payload = json.loads(cond.get("message", "{}"))
    require(cond.get("status") == "True"
            and payload.get("errors", {}).get("HBM_ECC_UNCORRECTABLE") == 1
            and payload.get("bootID") == checker.boot_id(),
            f"health: node condition {cond}")
    require(launches.get("scale_demo", 0) >= 1,
            f"health: K7 launches {launches}")

    want = scale_demo_plain(x)
    err = (y - want).abs().max().item()
    require(err == 0.0, f"health: K7 differs from x * 2.0 by {err}")
    n_bytes = 2 * x.numel() * x.element_size()
    bound, bound_by = bound_ms(n_bytes, x.numel(), "f32")
    result = {
        "phase": "health", "shape": list(shape), **k7_times(torch, x),
        "plain_ms": device_ms(torch, lambda: scale_demo_plain(x)),
        "library": "torch.mul(x, 2.0), which is also the plain version",
        "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
        "launches": launches,
        "provocations": {name: {"rc": code, "stderr_tail": text[-300:]}
                         for name, (code, text) in runs.items()},
        "discovered": devices,
        "torch_device_count": torch.cuda.device_count(),
        "chip_generation": manager.device_info.chip_generation(),
        "error_summary": summary, "health_after_ecc": health_after_ecc,
        "events": [(e["type"], e["reason"]) for e in k8s.events],
        "condition": {key: cond.get(key) for key in ("status", "reason",
                                                     "message")},
    }
    emit(result)
    return result


def time_roots(sub: str, flags: list[str], roots: list[str],
               timeout: float) -> int:
    """Run `chip_smoke.py SUB FLAGS` once for each ROOT, in order, each in
    a process of its own that imports the port from that checkout (-P:
    from PYTHONPATH, not from this file's directory); stop at the first
    that fails."""
    for root in roots:
        rc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), sub, *flags],
            env=dict(os.environ, PYTHONPATH=os.path.abspath(root)),
            timeout=timeout).returncode
        if rc:
            return rc
    return 0


def k4_timing(torch, dev, b: int, s: int) -> dict:
    """K4's ms beside SDPA's forward (timing only) in each k4_* case, on
    flash_phase's inputs at B x S."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    res = {"B": b, "S": s}
    for case, causal, seg, q, k, v, _ in _flash_cases(torch, dev, b, s):
        res[case] = device_ms(
            torch, lambda: fa.flash_fwd_cuda(q, k, v, seg, causal))
        sdpa, qt, kt, vt = _flash_sdpa(torch, q, k, v, seg, causal)
        res[f"{case}_sdpa"] = device_ms(
            torch, functools.partial(sdpa, qt.detach(), kt.detach(),
                                     vt.detach()), iters=10)
    return res


def k4_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py k4`: see the module's docstring."""
    import argparse

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py k4")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    if not args.roots:
        kernels.load()
        emit({"phase": "k4_timing", "nvidia_smi": nvidia_smi_line(),
              "kernels": os.path.dirname(kernels.__file__),
              **k4_timing(torch, torch.device("cuda", 0), args.batch,
                          args.seq)})
        return 0
    return time_roots("k4", ["--batch", str(args.batch), "--seq",
                             str(args.seq)], args.roots, 600)


def bwd_timing(torch, dev, b: int, s: int) -> dict:
    """K5's and K6's ms in each k5_*/k6_* case beside SDPA's backward
    (timing only; whole, and with only q requiring grad), and K4's, on
    flash_phase's inputs at B x S; each kernel's backward inputs come from
    K4."""
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    res = {"B": b, "S": s}
    for case, causal, seg, q, k, v, do in _flash_cases(torch, dev, b, s):
        out, lse = fa.flash_fwd_cuda(q, k, v, seg, causal)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, seg, do, lse, delta.contiguous(), causal)
        ms = {"k4": device_ms(
                  torch, lambda: fa.flash_fwd_cuda(q, k, v, seg, causal)),
              "k5": device_ms(torch, lambda: fa.flash_bwd_dq_cuda(*args)),
              "k6": device_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*args))}
        sdpa = _sdpa_times(torch, q, k, v, seg, causal, do)
        res[case] = {**ms, "pair": ms["k5"] + ms["k6"], **sdpa,
                     "pair_over_sdpa": ((ms["k5"] + ms["k6"])
                                        / sdpa["sdpa_backward_ms"])}
        del out, lse, delta, args
    return res


def bwd_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py bwd`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py bwd")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--train", action="store_true",
                    help="also the 8-layer llama3_8b train step")
    args = ap.parse_args(argv)
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "bwd_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **bwd_timing(torch, dev, args.batch, args.seq)}
        if args.train:
            gc.collect()
            torch.cuda.empty_cache()
            train = train_phase(torch, dev, np)
            res["train"] = {key: train[key] for key in (
                "median_step_ms", "step_ms_after_first",
                "device_busy_ms_per_step", "flash_ms_per_step")}
            res["train"]["flash_attention_ms_per_step"] = (
                train["device_ms_per_step_by_kind"].get("flash_attention"))
        emit(res)
        return 0
    return time_roots("bwd", ["--batch", str(args.batch), "--seq",
                              str(args.seq),
                              *(["--train"] if args.train else [])],
                      args.roots, 900)


def k2_timing(torch, dev) -> dict:
    """K2's and the library call's device ms in every k2_* case (cold
    weights, timing only: the full smoke checks them), and K7's beside
    torch.mul in turns."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = {}
    for name, t, d, f, kind in K2_CASES:
        x, qws = _k2_inputs(torch, dev, gen, t, d, f, kind)
        res[name] = k2_times(torch, dev, x, qws)
        del x, qws
    x = torch.randn(4096, 4096, generator=gen, device=dev)
    res["k7"] = k7_times(torch, x)
    return res


def k2_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py k2`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py k2")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--int8", action="store_true",
                    help="also llama3_8b's prefill and decode step on int8 "
                         "weights, beside bf16")
    args = ap.parse_args(argv)
    flags = ["--int8"] if args.int8 else []
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "k2_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **k2_timing(torch, dev)}
        if args.int8:
            from container_engine_accelerators_tpu_torch.models.llama import (
                init_params,
                llama3_8b,
            )
            from container_engine_accelerators_tpu_torch.ops.quant import (
                quantize_llama_params,
            )

            cfg = llama3_8b()
            model = init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            res["int8"] = int8_timing(
                torch, dev, model, quantize_llama_params(model), cfg,
                _int8_batch(torch, dev, np, cfg))
        emit(res)
        return 0
    return time_roots("k2", flags, args.roots, 900)


def decode_timing(torch, dev) -> dict:
    """K1's and K3's device ms in every k1_* and k3_* case and KV mode,
    on inputs from a seed (timing only: the full smoke checks them)."""
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    res = {}
    for mode in ("bf16", *KV_MODES):
        for name, t, b, lens in K1_CASES:
            args = _k1_args(torch, dev, gen, t, b, lens, mode)
            res[f"k1_{mode}_{name}"] = device_ms(
                torch, lambda: da.decode_attention_cuda(*args))
        for name, t, lens in K3_CASES:
            args = _k3_args(torch, dev, gen, t, lens, mode)
            res[f"k3_{mode}_{name}"] = device_ms(
                torch, lambda: da.paged_decode_attention_cuda(*args))
        del args
    return res


def tick_timing(torch, dev, np, model, cfg) -> dict:
    """paged_tick on llama3_8b at full width and depth (random weights
    from the seed): wall and device-busy ms per tick."""
    tick = paged_tick(torch, dev, np, model, cfg)
    return {key: tick[key] for key in (
        "paged_decode_tick_ms_8_slots", "device_busy_ms_per_tick",
        "device_idle_share", "launches_per_tick", "top_kernels_ms_per_tick")}


# The bodies of kernels/decode_attention.cu as torch.profiler names them;
# decode_attention_kernel is the prefill body before prefill_mma_kernel,
# so that an older checkout's prefill reads the same.
K1_BODIES = ("prefill_mma_kernel", "decode_split_kernel",
             "decode_attention_kernel")


def prefill_timing(torch, dev, np, model, cfg, runs: int = 8) -> dict:
    """One llama3_8b prefill of 2 x 512 new tokens from an empty cache
    through decode_step (the window engine's prefill): wall ms,
    device-synchronised around `runs` prefills, and from torch.profiler
    the device-busy ms, K1's ms and its share of the busy time."""
    from container_engine_accelerators_tpu_torch import kernels
    from container_engine_accelerators_tpu_torch.models import decode

    b, t = 2, 512
    prompt = _prompts(np, cfg, SEED + 6)
    tokens = torch.tensor([prompt(t) for _ in range(b)], device=dev)
    cache = decode.init_cache(cfg, b, 2048, dev)

    def prefill():
        decode.decode_step(model, cache, tokens, cfg)

    for _ in range(2):
        prefill()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(runs):
        prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / runs * 1e3
    launches = {name: n / runs for name, n in kernels.launches.items()}
    profile = profile_steps(torch, prefill)
    busy = profile["busy_ms_per_step"]
    k1_ms = None if busy is None else sum(
        ms for name, ms in profile["kernels"].items()
        if any(body in name for body in K1_BODIES))
    return {"prefill_2x512_ms": wall_ms, "device_busy_ms": busy,
            "k1_ms": k1_ms, "k1_share": None if busy is None else k1_ms / busy,
            "launches_per_prefill": launches,
            "top_kernels_ms": profile["top"]}


def decode_main(torch, argv: list[str]) -> int:
    """`chip_smoke.py decode`: see the module's docstring."""
    import argparse

    import numpy as np

    from container_engine_accelerators_tpu_torch import kernels

    ap = argparse.ArgumentParser(prog="chip_smoke.py decode")
    ap.add_argument("roots", nargs="*", metavar="ROOT",
                    help="a checkout to time in a process of its own")
    ap.add_argument("--tick", action="store_true",
                    help="also the paged tick on llama3_8b")
    ap.add_argument("--prefill", action="store_true",
                    help="also a 2 x 512 prefill on llama3_8b")
    args = ap.parse_args(argv)
    flags = [f"--{name}" for name in ("tick", "prefill")
             if getattr(args, name)]
    if not args.roots:
        dev = torch.device("cuda", 0)
        kernels.load()
        res = {"phase": "decode_timing", "nvidia_smi": nvidia_smi_line(),
               "kernels": os.path.dirname(kernels.__file__),
               **decode_timing(torch, dev)}
        if flags:
            from container_engine_accelerators_tpu_torch.models.llama import (
                init_params,
                llama3_8b,
            )

            cfg = llama3_8b()
            model = init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            if args.tick:
                res["tick"] = tick_timing(torch, dev, np, model, cfg)
            if args.prefill:
                res["prefill"] = prefill_timing(torch, dev, np, model, cfg)
        emit(res)
        return 0
    return time_roots("decode", flags, args.roots, 600)


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
    if sys.argv[1:2] == ["k4"]:
        return k4_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["bwd"]:
        return bwd_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["decode"]:
        return decode_main(torch, sys.argv[2:])
    if sys.argv[1:2] == ["k2"]:
        return k2_main(torch, sys.argv[2:])

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
        k1q = {mode: timed(f"k1_{mode}", k1_quant_phase, torch, dev, mode)
               for mode in KV_MODES}
        k3q = {mode: timed(f"k3_{mode}", k3_quant_phase, torch, dev, mode)
               for mode in KV_MODES}
        serve, model, cfg = timed("serve", serve_phase, torch, dev, np)
        int8 = timed("int8", int8_phase, torch, dev, np, model, cfg)
        paged = timed("paged", paged_phase, torch, dev, np, model, cfg)
        preempt = timed("paged_preempt", paged_preempt_phase, torch, dev,
                        np, model, cfg)
        cont = timed("continuous", continuous_phase, torch, dev, np, model,
                     cfg)
        kvq = timed("kv_quant", kv_quant_phase, torch, dev, np, model, cfg,
                    preempt)
        del model   # the training phases need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
        flash = timed("flash", flash_phase, torch, dev)
        train = timed("train", train_phase, torch, dev, np)
        gc.collect()
        torch.cuda.empty_cache()
        parity = timed("train_parity", train_parity_phase, torch, dev, np)
        gc.collect()
        torch.cuda.empty_cache()
        train_cli = timed("train_cli", train_cli_phase)
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp_dir:
            health = timed("health", health_phase, torch, dev, tmp_dir)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    emit({"phase_seconds": seconds})

    def launches(name):
        return sum(phase["launches"].get(name, 0)
                   for phase in (serve, int8, paged, preempt, cont, kvq))

    def prefill(case):
        """The main prefill case of K1 or K3, beside decode's."""
        return {"prefill_ms": case["ms"], "prefill_bound_ms": case["bound_ms"],
                "prefill_library_ms": case["library_ms"]}

    def quant_entries(base, source, replaces, results, main_case,
                      prefill_case):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bf16_kernel_ms", "library")
        return [{"name": f"{base}_{mode}", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches(f"{base}_{mode}"),
                 "max_abs_err": max(r["max_abs_err"]
                                    for r in results[mode].values()),
                 "max_row_rel_err": max(r["max_row_rel_err"]
                                        for r in results[mode].values()),
                 **{key: results[mode][main_case][key] for key in keys},
                 **prefill(results[mode][prefill_case])}
                for mode in KV_MODES]

    k1_row, k2_row, k3_row = (k1["decode_slots"], k2["w_gate_t8"],
                              k3["decode"])
    emit({"kernels": [
        {"name": "decode_attention", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches("decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k1.values()),
         **{key: k1_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
         **prefill(k1["prefill_512"])},
        {"name": "int8_matmul", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches("int8_matmul"),
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         **{key: k2_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
         **prefill(k2["w_gate_t1024"])},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": launches("paged_decode_attention"),
         "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
         "max_row_rel_err": max(r["max_row_rel_err"] for r in k3.values()),
         **{key: k3_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "k1_contiguous_ms", "library")},
         **prefill(k3["prefill_chunk_512"])},
        *({"name": name, "route": "cuda", "source": FLASH_SOURCE,
           "replaces": FLASH_REPLACES[name],
           "launches": train["launches"].get(name, 0),
           "max_abs_err": max(r["max_abs_err"] for r in flash[name].values()),
           "max_row_rel_err": max(r["max_row_rel_err"]
                                  for r in flash[name].values()),
           **flash[name]["main"]} for name in FLASH_REPLACES),
        *quant_entries("decode_attention", K1_SOURCE, K1_REPLACES, k1q,
                       "decode_slots", "prefill_512"),
        *quant_entries("paged_decode_attention", K3_SOURCE, K3_REPLACES, k3q,
                       "decode", "prefill_chunk_512"),
        {"name": "scale_demo", "route": "cuda", "source": K7_SOURCE,
         "replaces": K7_REPLACES,
         "launches": health["launches"].get("scale_demo", 0),
         **{key: health[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "library", "ms_runs",
                                         "library_ms_runs")}},
    ]})
    emit({"train_summary": {
        "median_step_ms": train["median_step_ms"],
        "tokens_per_s": train["tokens_per_s"], "mfu": train["mfu"],
        "device_busy_share": train["device_busy_share"],
        "max_memory_allocated_bytes": train["max_memory_allocated_bytes"],
        "parity_max_grad_rel_diff": parity["max_grad_rel_diff"],
        "cli_tokens_per_sec": train_cli["tokens_per_sec"]}})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
