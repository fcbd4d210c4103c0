"""The layout contract of the JAX package's `sp_shard_map`, over ranks.

In the JAX package, ring and Ulysses attention run under shard_map with
the spec [batch=(dp, fsdp), seq=sp, heads=tp, head_dim] on every
argument and the output: each device holds one block of a global
[B, S, ...] array. Torch needs no shard_map, because each rank already
runs its own program on its own block. What stays is which block a rank
holds, written out here so that the batch (training/train.shard_batch),
the attention layers and the tests agree on it:

  local_rows   the rank's rows along the batch axes (dp outer, fsdp inner)
  local_cols   the rank's columns along sp
  gather_sp    the global sequence again from every sp rank's columns

`block` and `gather` are the two operations under these, which
parallel/sharding.py's parameter shards share: block i of n equal
blocks along a dim, and every rank's block concatenated again along it.

The JAX module's other function, `compat_shard_map` (shard_map across
jax versions), has no counterpart: there is nothing to map.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
)


def local_rows(x, mesh: Mesh, dim: int = 0):
    """This rank's block of `x` along `dim` split over the batch axes
    (dp, fsdp): block dp_index * fsdp + fsdp_index of dp * fsdp equal
    blocks. Works on numpy arrays and tensors."""
    return block(x, mesh.axis_size(*BATCH_AXES), mesh.index(*BATCH_AXES),
                 dim)


def local_cols(x, mesh: Mesh, dim: int = 1):
    """This rank's block of `x` along `dim` (the sequence) split over sp."""
    return block(x, mesh.axis_size("sp"), mesh.coord["sp"], dim)


def block(x, n: int, i: int, dim: int):
    """Block `i` of `n` equal blocks of `x` along `dim`: a view where
    slicing allows, for tensors and numpy arrays."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal blocks")
    step = size // n
    idx = [slice(None)] * len(x.shape)
    idx[dim] = slice(i * step, (i + 1) * step)
    return x[tuple(idx)]


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated along `dim` in group-rank
    order."""
    n = dist.get_world_size(group)
    part = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * part.shape[0],) + part.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, part, group=group)
    return out.movedim(0, dim).contiguous()


@torch.no_grad()
def gather_sp(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """Every sp rank's block of the sequence, concatenated in sp order
    along `dim` (no gradient)."""
    if mesh.axis_size("sp") == 1:
        return x
    return gather(x, dim, mesh.group("sp"))
