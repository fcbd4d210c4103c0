"""Int8 quantization for the decode path: weights and the KV cache.

Weights, symmetric per output channel (scale = absmax / 127 over the
contraction dim):
  qw = quantize_weights(w)              # [..., D, F] -> int8 + f32 [..., F]
  y = int8_matmul(x, qw)                # [T, D] @ [D, F] -> [T, F] x.dtype
  qmodel = quantize_llama_params(model) # every projection and the lm_head
Decoding at small batch streams every weight once per step, so int8
storage halves the bytes of the bf16 weight stream; `int8_matmul`
dispatches on the device: CUDA launches kernels/int8_matmul.cu (int8
converted to bf16 in registers, products on the tensor cores, one launch
a call as `plan` lays it out), CPU runs `int8_matmul_plain`.

KV cache, symmetric per (token, KV head), scales head-major:
  q, s = quantize_kv(kv)        # [..., T, Hkv, D] -> int8, f32 [..., Hkv, T]
  kv = dequantize_kv(q, s)
  p, s = quantize_kv_int4(kv)   # int8 [..., D/2]: two nibbles a byte
  kv = dequantize_kv_int4(p, s)
Int8 stores a cached token in about half the bytes of bf16, int4 in about
a quarter; ops/decode_attention dequantizes inside its kernels. These
are plain tensor code, as in the JAX package (XLA there, no Pallas), and
every function here is bit-identical to the JAX package's on the same
inputs: both round half to even and divide in IEEE f32.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch
from torch import nn

from container_engine_accelerators_tpu_torch import kernels

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# kernels/int8_matmul.cu's bodies and tiles. int8_mma_kernel: output
# columns a CTA (kCols), rows of D a stage (kDepth), the token tiles it is
# built for (NT). int8_wgmma_kernel, bf16 x at 128 tokens: kWgCols,
# kWgDepth.
BODIES = ("int8_mma_kernel", "int8_wgmma_kernel")
COLS_PER_BLOCK = {"int8_mma_kernel": 128, "int8_wgmma_kernel": 256}
DEPTH = {"int8_mma_kernel": 64, "int8_wgmma_kernel": 128}
TOKEN_TILES = (8, 16, 32, 64, 128)
DECODE_TOKENS = 16         # NT up to it: bound by bytes, 4 CTAs an SM


class QuantWeight(nn.Module):
    """int8 `values` (the source weight's shape) and f32 per-output-
    channel `scales` (its last dim). A module, so it can stand where a
    weight Parameter stood and moves with `.to(device)`."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        if values.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError("QuantWeight wants int8 values, f32 scales")
        self.register_buffer("values", values)
        self.register_buffer("scales", scales)

    @property
    def shape(self) -> torch.Size:
        return self.values.shape


def quantize_weights(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8, absmax reduced over axis -2
    only (stacked [L, D, F] weights get per-(layer, channel) scales)."""
    w_f = w.float()
    absmax = w_f.abs().amax(dim=-2, keepdim=True)
    scales = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w_f / scales), -127, 127).to(torch.int8)
    return QuantWeight(q, scales.squeeze(-2))


def dequantize(qw: QuantWeight, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    return (qw.values.float() * qw.scales[..., None, :]).to(dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., T, Hkv, D] -> (int8 [..., T, Hkv, D], f32 scales
    [..., Hkv, T]): scale = absmax / 127 over D, one per token and KV
    head, so an appended token never rescales its neighbours."""
    x_f = x.float()
    scales = x_f.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x_f / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales.transpose(-1, -2)


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_kv: int8 [..., T, Hkv, D] and head-major
    scales [..., Hkv, T] -> [..., T, Hkv, D] in `dtype`, the product
    taken in f32."""
    return (q.float() * scales.transpose(-1, -2)[..., None]).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Integers in [-8, 7] [..., D] -> int8 [..., D/2], split-half: byte j
    holds element j in its low nibble and element j + D/2 in its high
    nibble. The byte is formed in int32 and mapped to [-128, 127] before
    the cast, so no wraparound of the cast is relied on."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"pack_int4 needs an even last dim, got {d}")
    qi = q.to(torch.int32)
    byte = (qi[..., :d // 2] & 0xF) | ((qi[..., d // 2:] & 0xF) << 4)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: int8 [..., D/2] -> int32 [..., D], each
    nibble sign-extended. (n ^ 8) - 8 is the JAX package's
    (b << 28) >> 28 for the low nibble without a shift into the sign bit;
    the high nibble is an arithmetic shift of the sign-extended byte."""
    b = packed.to(torch.int32)
    return torch.cat([((b & 0xF) ^ 8) - 8, b >> 4], dim=-1)


def quantize_kv_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., T, Hkv, D] -> (packed int8 [..., T, Hkv, D/2], f32 scales
    [..., Hkv, T]): quantize_kv's layout at scale = absmax / 7."""
    x_f = x.float()
    scales = x_f.abs().amax(dim=-1).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(x_f / scales[..., None]), -7, 7)
    return pack_int4(q), scales.transpose(-1, -2)


def dequantize_kv_int4(packed: torch.Tensor, scales: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of quantize_kv_int4: packed [..., T, Hkv, D/2] and scales
    [..., Hkv, T] -> [..., T, Hkv, D] in `dtype`."""
    return (unpack_int4(packed).float()
            * scales.transpose(-1, -2)[..., None]).to(dtype)


def _check(x: torch.Tensor, qw: QuantWeight):
    if x.ndim != 2 or qw.values.ndim != 2:
        raise ValueError(f"want x [T, D] and weight [D, F], got "
                         f"{tuple(x.shape)}, {tuple(qw.values.shape)}")
    if x.shape[1] != qw.values.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not contract with "
                         f"weight {tuple(qw.values.shape)}")


def int8_matmul_plain(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """(x @ q) * s with an f32 sum, in x.dtype: the kernel's function in
    plain PyTorch. int8 values are exact in bf16 and f32, so this is the
    TPU kernel's bf16(q) product to the order of summation."""
    _check(x, qw)
    acc = x.float() @ qw.values.float()
    return (acc * qw.scales).to(x.dtype)


class Int8Plan(NamedTuple):
    """How kernels/int8_matmul.cu lays out one call: `body` on a grid of
    (token_tiles, col_tiles, splits) CTAs, each `tokens` rows of x by
    COLS_PER_BLOCK[body] output columns over `d_per_split` rows of D."""
    body: str
    tokens: int
    token_tiles: int
    col_tiles: int
    splits: int
    d_per_split: int


def plan(t: int, d: int, f: int, sms: int, x_bf16: bool = True,
         vec: int = 16) -> Int8Plan:
    """The launch for x [t, d] @ q [d, f] on a card of `sms` SMs, x in
    bf16 or f32, weight rows copied `vec` bytes at a time. bf16 x past 64
    rows, with 16-byte rows, takes the wgmma body (128 tokens by 256
    columns a CTA, one CTA an SM), split over D until the grid fills at
    most one wave. Otherwise the mma.sync body: the smallest token tile
    that holds t (128 past it), D split until the grid has ~4 CTAs an SM
    at decode (the weight stream wants every SM busy, each CTA at least
    2 stages deep) or ~1 at prefill. A
    function of the shapes, the SM count and the copy width only, so a
    call reads nothing on the host and a CUDA graph can hold it; each
    split is a whole number of DEPTH[body]-row stages, the last ragged."""
    if min(t, d, f, sms) < 1:
        raise ValueError(f"int8_matmul plan of an empty product: t={t}, "
                         f"d={d}, f={f}, sms={sms}")
    tokens = next((n for n in TOKEN_TILES if t <= n), TOKEN_TILES[-1])
    wgmma = x_bf16 and tokens == TOKEN_TILES[-1] and vec == 16
    body = BODIES[wgmma]
    token_tiles = -(-t // tokens)
    col_tiles = -(-f // COLS_PER_BLOCK[body])
    stages = -(-d // DEPTH[body])
    if wgmma:
        splits = sms // (token_tiles * col_tiles)
    elif tokens <= DECODE_TOKENS:
        # ~4 CTAs an SM, each streaming at least 2 stages.
        splits = min(-(-4 * sms // (token_tiles * col_tiles)), stages // 2)
    else:
        splits = -(-sms // (token_tiles * col_tiles))
    splits = max(1, min(splits, stages))
    d_per_split = -(-stages // splits) * DEPTH[body]
    return Int8Plan(body, tokens, token_tiles, col_tiles,
                    -(-d // d_per_split), d_per_split)


_tickets: dict = {}
_tickets_lock = threading.Lock()


def _workspace(p: Int8Plan, t: int, f: int, device
               ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(partials [splits, t, f] f32, tickets) for a split call, (None,
    None) for one split. The partials are allocated per call (the
    caching allocator hands them back after it, in stream order); the
    int32 tickets persist per device and are zero between calls: the
    last CTA of each output tile resets its own, so two streams must not
    run the kernel at once on one device."""
    if p.splits == 1:
        return None, None
    part = torch.empty((p.splits, t, f), dtype=torch.float32, device=device)
    n = p.token_tiles * p.col_tiles
    with _tickets_lock:
        tickets = _tickets.get(device)
        if tickets is None or tickets.numel() < n:
            tickets = torch.zeros(n, dtype=torch.int32, device=device)
            _tickets[device] = tickets
    return part, tickets


def _copy_width(f: int, ptr: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that every weight row's
    start allows."""
    return next(v for v in (16, 8, 4) if f % v == 0 and ptr % v == 0)


def pad_plan(d: int, f: int, ptr: int, contiguous: bool = True
             ) -> tuple[int, int] | None:
    """The (D, F) the kernel is given for a weight [d, f] at address
    `ptr`: None when it takes the weight as it is (contiguous, F % 4 == 0,
    4-byte aligned rows, D % 8 == 0), else D rounded up to 8 and F to 16
    (zero rows and columns, 16-byte rows). A zero row of D meets a zero
    column of x, and a zero column of F is sliced off y, so the padded
    product is the same function."""
    if contiguous and f % 4 == 0 and ptr % 4 == 0 and d % 8 == 0:
        return None
    return -(-d // 8) * 8, -(-f // 16) * 16


def _padded_operands(qw: QuantWeight, d_k: int, f_k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight and scales zero-padded to [d_k, f_k] and [f_k], made
    once per QuantWeight and kept on it until its values change."""
    w, s = qw.values, qw.scales
    key = (w.data_ptr(), w._version, s.data_ptr(), s._version, d_k, f_k)
    cached = getattr(qw, "_padded", None)
    if cached is None or cached[0] != key:
        d, f = w.shape
        w_k = torch.zeros((d_k, f_k), dtype=torch.int8, device=w.device)
        w_k[:d, :f] = w
        s_k = torch.zeros(f_k, dtype=torch.float32, device=s.device)
        s_k[:f] = s
        cached = qw._padded = (key, w_k, s_k)
    return cached[1], cached[2]


def int8_matmul_cuda(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Launch kernels/int8_matmul.cu on CUDA tensors: one launch, laid
    out by `plan`. A weight the kernel cannot take as it is goes in
    zero-padded by `pad_plan` (once per QuantWeight) with x padded to
    match, and an x not 16-byte aligned is copied, so every shape the
    plain version takes runs through the kernel."""
    _check(x, qw)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul kernel takes bf16 or f32 x, "
                        f"got {x.dtype}")
    w, s = qw.values, qw.scales
    if w.device != x.device or s.device != x.device:
        raise ValueError("x and the QuantWeight must share a device")
    t, d = x.shape
    f = w.shape[1]
    padded = pad_plan(d, f, w.data_ptr(),
                      w.is_contiguous() and s.is_contiguous())
    if padded is not None:
        d_k, f_k = padded
        w, s = _padded_operands(qw, d_k, f_k)
        if d_k != d:
            x = torch.nn.functional.pad(x, (0, d_k - d))
    else:
        d_k, f_k = d, f
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()   # a fresh allocation is aligned
    y = torch.empty((t, f_k), dtype=x.dtype, device=x.device)
    if t == 0:
        return y[:, :f]
    vec = _copy_width(f_k, w.data_ptr())
    x_bf16 = x.dtype == torch.bfloat16
    p = plan(t, d_k, f_k, kernels.sm_count(x.device), x_bf16, vec)
    part, tickets = _workspace(p, t, f_k, x.device)
    err = kernels.load().int8_matmul(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
        0 if part is None else part.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), int(x_bf16), t, d_k,
        f_k, BODIES.index(p.body), p.tokens, p.d_per_split, p.splits, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check("int8_matmul", err)
    return y if f_k == f else y[:, :f].contiguous()


def int8_matmul(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """x [T, D] (bf16 or f32) @ int8 weight [D, F] -> [T, F] in x.dtype."""
    if x.device.type == "cuda":
        return int8_matmul_cuda(x, qw)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qw)
    raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")


def quantize_llama_params(model):
    """A copy of a models.llama.Llama whose projections and lm_head are
    QuantWeights; norms and the embedding are shared with `model`."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        Llama,
        LlamaLayer,
        layer_weights,
    )

    layers = []
    for layer in model.layers:
        weights = {name: getattr(layer, name)
                   for name in layer_weights(model.cfg)}
        weights.update({name: quantize_weights(weights[name])
                        for name in QUANT_KEYS})
        layers.append(LlamaLayer(**weights))
    return Llama(model.cfg, embed=model.embed, layers=layers,
                 final_norm=model.final_norm,
                 lm_head=quantize_weights(model.lm_head))


def dequantize_llama_params(model, dtype: torch.dtype = torch.float32):
    """The inverse of quantize_llama_params: a copy of the model with
    every QuantWeight expanded to a dense `dtype` weight (the JAX
    package's eval quality gate: the training forward over the int8
    round trip, which the decode path's kernel dequantizes alike)."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        Llama,
        LlamaLayer,
        layer_weights,
    )

    def dense(w):
        return dequantize(w, dtype) if isinstance(w, QuantWeight) else w

    layers = [LlamaLayer(**{name: dense(getattr(layer, name))
                            for name in layer_weights(model.cfg)})
              for layer in model.layers]
    return Llama(model.cfg, embed=model.embed, layers=layers,
                 final_norm=model.final_norm,
                 lm_head=dense(model.lm_head))
