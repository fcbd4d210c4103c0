"""Attention for the training forward: the plain reference and the
dispatch to flash attention (ops/flash_attention.py).

Layouts as in the JAX package: q [B, S, Hq, D], k/v [B, S, Hkv, D],
output [B, S, Hq, D] in q.dtype.
"""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch.ops import flash_attention as fa


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]: q head h reads KV head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        segment_ids: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain softmax attention: f32 scores and softmax statistics, masks
    of -inf, probabilities cast to q.dtype before the product with v
    (accumulated in f32), output in q.dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s_q, s_k = q.shape[1], k.shape[1]
    if causal:
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = logits.masked_fill(~same, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, use_flash: bool | None = None,
                         causal_grid: str | None = None,
                         plain: bool = False) -> torch.Tensor:
    """Flash attention where it engages, the reference elsewhere.

    `use_flash=None` takes flash attention on a CUDA tensor, where the
    hand-written kernels run, and the reference on the CPU (the JAX
    package resolves None by the backend, to flash on a TPU only).
    `use_flash=True` takes flash on any device: on the CPU that is its
    plain PyTorch version. Flash engages only where `fa.supported` holds
    (head_dim a multiple of 128, S a multiple of 128 and at least 256);
    other shapes take the reference, as in the JAX package. `causal_grid`
    ('rect' | 'tri' | None) is validated whether or not flash engages.
    `plain=True` runs flash attention's plain versions on the card too
    (the on-card reference for the kernels)."""
    if causal_grid not in (None, "rect", "tri"):
        raise ValueError(f"causal_grid must be 'rect' or 'tri', "
                         f"got {causal_grid!r}")
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    if use_flash and fa.supported(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal,
                                  causal_grid=causal_grid or "rect",
                                  plain=plain)
    return reference_attention(q, k, v, causal=causal)
