"""Rotary position embeddings (RoPE), Llama-3 style: split-half rotation
computed in f32, with an optional gather of table rows by position."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500_000.0,
                     device: str | torch.device | None = None,
                     dtype: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, each [max_seq_len, head_dim // 2]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """x: [..., S, H, D]; cos/sin: [S_table, D/2]. `positions` ([..., S]
    integer) selects table rows; defaults to arange(S)."""
    seq_len = x.shape[-3]
    if positions is None:
        c, s = cos[:seq_len], sin[:seq_len]
    else:
        c, s = cos[positions], sin[positions]
    c = c.unsqueeze(-2)   # broadcast over heads
    s = s.unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
