"""Flash attention for training: the forward (K4) and its dq (K5) and
dk/dv (K6) backward kernels, behind one autograd.Function.

`flash_attention(q, k, v)` keeps the JAX package's interface: q
[B, S, Hq, D], k/v [B, S, Hkv, D], output [B, S, Hq, D] in q.dtype. The
function, step by step as in the Pallas version:
  - q is pre-scaled and rounded in its dtype, qs = (q.f32 * D^-0.5).to(
    q.dtype); the forward returns out and lse [B, Hq, S] (f32);
  - the backward takes delta = sum(do.f32 * out.f32) [B, Hq, S], then dq
    (w.r.t. qs, multiplied by D^-0.5 at the end and rounded again) and
    dk, dv; the GQA sum over a KV head's q heads is taken in f32.
Masked scores are NEG_INF = -1e30, not -inf (see the CUDA source).

Each kernel has a plain PyTorch version beside it (`flash_fwd_plain`,
`flash_bwd_dq_plain`, `flash_bwd_dkv_plain`) with the same blockwise
arithmetic: 128-key tiles online in the forward (K4's tile), f32
accumulators, p and ds rounded to the operand dtype before their
products. CPU tensors take the plain versions; CUDA tensors take the
kernels (kernels/flash_attention.cu), which take bf16, head_dim 128 and
S a multiple of 128 (K4) or 64 (K5, K6), and raise on anything else.
`plain=True` runs the plain versions on the card, as the kernels'
reference.

`causal_grid` 'rect' and 'tri' are both accepted and compute the same
thing: on the TPU they are two schedules of the causal grid (tri skips
the DMA of blocks above the diagonal), while the CUDA kernels never
visit a block above the diagonal, so the choice has nothing to select.
The TPU block sizes and `interpret` are gone; the tiles are the CUDA
kernels' own.
"""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch import kernels

NEG_INF = -1e30
FWD_KEY_TILE = 128  # K4 steps over keys by it (and takes q rows by it)
KEY_TILE = 64       # K5 steps over keys by it
Q_TILE = 32         # K6 steps over queries by it
KERNEL_HEAD_DIM = 128


def supported(q, k, v) -> bool:
    """The JAX package's shape gate for the flash path."""
    b, s, h, d = q.shape
    return d % 128 == 0 and s % 128 == 0 and s >= 256


def _prescale(q: torch.Tensor) -> torch.Tensor:
    return (q.float() * q.shape[-1] ** -0.5).to(q.dtype)


def _heads(x: torch.Tensor, n_rep: int = 1) -> torch.Tensor:
    """[B, S, H, D] -> f32 [B, H * n_rep, S, D] (KV heads repeated)."""
    x = x.float().permute(0, 2, 1, 3)
    return x.repeat_interleave(n_rep, dim=1) if n_rep > 1 else x


def _mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          seg: torch.Tensor | None) -> torch.Tensor | None:
    """Visible (query row, key col) pairs, broadcastable to
    [B, H, rows, cols]; None where all are."""
    mask = None
    if causal:
        mask = rows[:, None] >= cols[None, :]
    if seg is not None:
        same = (seg[:, rows][:, :, None] == seg[:, cols][:, None, :])[:, None]
        mask = same if mask is None else mask & same
    return mask


def flash_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seg: torch.Tensor | None, causal: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's function: (out [B, S, Hq, D] in qs.dtype, lse [B, Hq, S] f32)
    from pre-scaled qs, by the online softmax over 128-key tiles."""
    b, s, hq, d = qs.shape
    n_rep = hq // k.shape[2]
    qh, kh, vh = _heads(qs), _heads(k, n_rep), _heads(v, n_rep)
    m = torch.full((b, hq, s, 1), NEG_INF, device=qs.device)
    l = torch.zeros((b, hq, s, 1), device=qs.device)
    acc = torch.zeros((b, hq, s, d), device=qs.device)
    rows = torch.arange(s, device=qs.device)
    for k0 in range(0, s, FWD_KEY_TILE):
        cols = rows[k0:k0 + FWD_KEY_TILE]
        sc = qh @ kh[:, :, k0:k0 + FWD_KEY_TILE].transpose(-1, -2)
        mask = _mask(rows, cols, causal, seg)
        if mask is not None:
            sc = sc.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + (p.to(v.dtype).float()
                             @ vh[:, :, k0:k0 + FWD_KEY_TILE])
        m = m_new
    l = l.clamp(min=1e-30)
    out = (acc / l).to(qs.dtype).permute(0, 2, 1, 3).contiguous()
    return out, (m + torch.log(l)).squeeze(-1)


def flash_bwd_dq_plain(qs, k, v, seg, do, lse, delta, causal: bool
                       ) -> torch.Tensor:
    """K5's function: dq [B, S, Hq, D] in qs.dtype, w.r.t. qs, summed
    over 64-key tiles in f32."""
    b, s, hq, d = qs.shape
    n_rep = hq // k.shape[2]
    qh, kh, vh, doh = _heads(qs), _heads(k, n_rep), _heads(v, n_rep), \
        _heads(do)
    acc = torch.zeros((b, hq, s, d), device=qs.device)
    rows = torch.arange(s, device=qs.device)
    for k0 in range(0, s, KEY_TILE):
        kb = kh[:, :, k0:k0 + KEY_TILE]
        sc = qh @ kb.transpose(-1, -2)
        mask = _mask(rows, rows[k0:k0 + KEY_TILE], causal, seg)
        if mask is not None:
            sc = sc.masked_fill(~mask, NEG_INF)
        p = torch.exp(sc - lse[..., None])
        dp = doh @ vh[:, :, k0:k0 + KEY_TILE].transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        acc = acc + ds.to(k.dtype).float() @ kb
    return acc.to(qs.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkv_plain(qs, k, v, seg, do, lse, delta, causal: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's function: (dk, dv) [B, S, Hkv, D] in k.dtype, summed over
    32-query tiles and over each KV head's q heads in f32."""
    b, s, hq, d = qs.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    qh, kh, vh, doh = _heads(qs), _heads(k, n_rep), _heads(v, n_rep), \
        _heads(do)
    dk = torch.zeros((b, hq, s, d), device=qs.device)
    dv = torch.zeros((b, hq, s, d), device=qs.device)
    keys = torch.arange(s, device=qs.device)
    for q0 in range(0, s, Q_TILE):
        qb, dob = qh[:, :, q0:q0 + Q_TILE], doh[:, :, q0:q0 + Q_TILE]
        # Transposed scores: rows are keys, columns queries.
        sc = kh @ qb.transpose(-1, -2)
        mask = _mask(keys[q0:q0 + Q_TILE], keys, causal, seg)
        if mask is not None:
            sc = sc.masked_fill(~mask.transpose(-1, -2), NEG_INF)
        p = torch.exp(sc - lse[:, :, None, q0:q0 + Q_TILE])
        dv = dv + p.to(do.dtype).float() @ dob
        dp = vh @ dob.transpose(-1, -2)
        ds = p * (dp - delta[:, :, None, q0:q0 + Q_TILE])
        dk = dk + ds.to(qs.dtype).float() @ qb

    def per_kv_head(x):
        x = x.reshape(b, hkv, n_rep, s, d).sum(2)
        return x.to(k.dtype).permute(0, 2, 1, 3).contiguous()

    return per_kv_head(dk), per_kv_head(dv)


def _check_kernel_inputs(name: str, *tensors, seq_tile: int = KEY_TILE
                         ) -> None:
    """Raise on what the kernels cannot take."""
    q = tensors[0]
    if q.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"{name} kernel takes head_dim {KERNEL_HEAD_DIM}, "
                         f"got {q.shape[-1]}")
    if q.shape[1] % seq_tile:
        raise ValueError(f"{name} kernel takes S a multiple of {seq_tile}, "
                         f"got {q.shape[1]}")
    for x in tensors:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name}: tensors on {x.device} and {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte "
                             "aligned tensors")


def _check_stats(q: torch.Tensor, *stats) -> None:
    """lse and delta: contiguous f32 [B, Hq, S] on q's device."""
    b, s, hq, _ = q.shape
    for x in stats:
        if x.dtype != torch.float32 or x.shape != (b, hq, s) or \
                x.device != q.device or not x.is_contiguous():
            raise ValueError("lse and delta must be contiguous f32 "
                             f"[{b}, {hq}, {s}] tensors on {q.device}")


def _seg_ptr(seg: torch.Tensor | None, q: torch.Tensor):
    if seg is None:
        return None
    # K4 reads the ids 16 bytes at a time.
    if seg.dtype != torch.float32 or seg.device != q.device or \
            seg.shape != q.shape[:2] or not seg.is_contiguous() or \
            seg.data_ptr() % 16:
        raise ValueError("segment ids must be a contiguous, 16-byte aligned "
                         "f32 [B, S] tensor on the device of q")
    return seg.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd_cuda(qs, k, v, seg, causal: bool):
    """Launch K4 on CUDA tensors."""
    _check_kernel_inputs("flash_fwd", qs, k, v, seq_tile=FWD_KEY_TILE)
    b, s, hq, d = qs.shape
    out = torch.empty_like(qs)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=qs.device)
    err = kernels.load().flash_fwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(seg, qs),
        out.data_ptr(), lse.data_ptr(), b, s, hq, k.shape[2], d,
        int(causal), _stream(qs))
    kernels.check("flash_fwd", err)
    return out, lse


def flash_bwd_dq_cuda(qs, k, v, seg, do, lse, delta, causal: bool):
    """Launch K5 on CUDA tensors."""
    _check_kernel_inputs("flash_bwd_dq", qs, k, v, do)
    _check_stats(qs, lse, delta)
    b, s, hq, d = qs.shape
    dq = torch.empty_like(qs)
    err = kernels.load().flash_bwd_dq_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(seg, qs),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b,
        s, hq, k.shape[2], d, int(causal), _stream(qs))
    kernels.check("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv_cuda(qs, k, v, seg, do, lse, delta, causal: bool):
    """Launch K6 on CUDA tensors."""
    _check_kernel_inputs("flash_bwd_dkv", qs, k, v, do)
    _check_stats(qs, lse, delta)
    b, s, hq, d = qs.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = kernels.load().flash_bwd_dkv_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(seg, qs),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, hq, k.shape[2], d, int(causal), _stream(qs))
    kernels.check("flash_bwd_dkv", err)
    return dk, dv


def _route(x: torch.Tensor, plain: bool) -> str:
    if plain or x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "cuda"
    raise ValueError(f"flash_attention runs on cuda or cpu, not {x.device}")


_FWD = {"plain": flash_fwd_plain, "cuda": flash_fwd_cuda}
_BWD_DQ = {"plain": flash_bwd_dq_plain, "cuda": flash_bwd_dq_cuda}
_BWD_DKV = {"plain": flash_bwd_dkv_plain, "cuda": flash_bwd_dkv_cuda}


class FlashAttention(torch.autograd.Function):
    """Forward K4; backward delta, then K5 and K6. Saves the pre-scaled
    q (the backward's operand), k, v, segment ids, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal: bool, plain: bool):
        route = _route(q, plain)
        qs = _prescale(q.contiguous())
        k, v = k.contiguous(), v.contiguous()
        out, lse = _FWD[route](qs, k, v, seg, causal)
        ctx.save_for_backward(qs, k, v, seg, out, lse)
        ctx.causal, ctx.route = causal, route
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, seg, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        args = (qs, k, v, seg, do, lse, delta.contiguous(), ctx.causal)
        dq = _BWD_DQ[ctx.route](*args)
        dk, dv = _BWD_DKV[ctx.route](*args)
        dq = (dq.float() * qs.shape[-1] ** -0.5).to(dq.dtype)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segment_ids: torch.Tensor | None = None,
                    causal_grid: str = "rect",
                    plain: bool = False) -> torch.Tensor:
    """q [B, S, Hq, D]; k, v [B, S, Hkv, D] -> [B, S, Hq, D] in q.dtype.

    `segment_ids` ([B, S] int) keeps attention inside each packed
    sequence; it rides as an f32 carrier, as in the JAX package.
    `causal_grid` is 'rect' or 'tri' (see the module docstring)."""
    if causal_grid not in ("rect", "tri"):
        raise ValueError(f"causal_grid must be 'rect' or 'tri', "
                         f"got {causal_grid!r}")
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"want q [B,S,Hq,D] and k/v [B,S,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device,
                             dtype=torch.float32).contiguous()
    return FlashAttention.apply(q, k, v, seg, causal, plain)
