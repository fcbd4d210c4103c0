"""Ulysses sequence parallelism over the 'sp' axis, the JAX package's
parallel/ulysses.py over ranks.

One all-to-all scatters the heads and gathers the sequence, [B, S/sp,
H, D] to [B, S, H/sp, D]; the rank then runs whole-sequence attention
on its head group through ops/attention.multi_head_attention (on the
card K4 forward and K5/K6 backward, at Hq/sp and Hkv/sp heads); the
inverse all-to-all brings the sequence chunk back with every head. KV
heads move without repetition, so the GQA ratio holds on each rank.
Both all-to-alls are one autograd function whose backward is the
inverse all-to-all. gloo takes all_to_all_single on CUDA tensors, so
the same form serves every placement.

Constraints, with the JAX package's messages: n_heads and n_kv_heads
divisible by sp (the scatter axis), and S by sp.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.ops.attention import (
    multi_head_attention,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import Mesh


def _all_to_all(x: torch.Tensor, group, scatter_dim: int,
                gather_dim: int) -> torch.Tensor:
    """x split into n blocks along scatter_dim, block j to rank j; the
    blocks received concatenated along gather_dim in rank order."""
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=scatter_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=gather_dim)


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_dim: int, gather_dim: int):
        ctx.group, ctx.dims = group, (scatter_dim, gather_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return (_all_to_all(g, ctx.group, gather_dim, scatter_dim), None,
                None, None)


def check_heads(n_heads: int, n_kv_heads: int, sp: int, tp: int = 1) -> None:
    """The JAX package's divisibility rule for the head scatter."""
    for name, h in (("n_heads", n_heads), ("n_kv_heads", n_kv_heads)):
        if h % (sp * tp):
            raise ValueError(
                f"ulysses needs {name} ({h}) divisible by sp*tp="
                f"{sp * tp}")


def ulysses_attention(q, k, v, mesh: Mesh, causal: bool = True,
                      use_flash: bool | None = None,
                      causal_grid: str | None = None,
                      plain: bool = False):
    """q [B, S/sp, Hq, D], k/v [B, S/sp, Hkv, D] (this rank's chunk of
    the sequence) -> [B, S/sp, Hq, D]."""
    sp = mesh.axis_size("sp")
    check_heads(q.shape[2], k.shape[2], sp, mesh.axis_size("tp"))
    if sp == 1:
        return multi_head_attention(q, k, v, causal=causal,
                                    use_flash=use_flash,
                                    causal_grid=causal_grid, plain=plain)
    group = mesh.group("sp")
    qg, kg, vg = (AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    out = multi_head_attention(qg, kg, vg, causal=causal,
                               use_flash=use_flash,
                               causal_grid=causal_grid, plain=plain)
    return AllToAll.apply(out, group, 1, 2)
