"""Sharding rules: where the Llama parameters and activations lie on the
(pp, dp, fsdp, ep, sp, tp) mesh, the JAX package's parallel/sharding.py
as data, and the two operations that realize them over ranks.

Parameter placement (the JAX package's, each spec a tuple of one entry a
dim: None, an axis name, or a tuple of axis names):
  - vocab / ff / head dims -> tp
  - the d_model dim        -> fsdp (ZeRO-3: every rank keeps 1/fsdp of
                              each weight and its AdamW moments in f32)
  - the stacked layer dim  -> pp with a pipeline, else unsharded
The port stores a layer's weights one module a layer, so a weight's spec
here (`param_spec`) is the JAX spec without its layer entry.

In the JAX package GSPMD inserts the collectives. Here `GatherShard`
does: its forward casts the local f32 shard to the compute dtype and
all-gathers it over fsdp (inside each layer's checkpointed region, so a
backward under 'dots' gathers again instead of keeping the whole weight
alive); its backward reduce-scatters the full gradient in f32 back to
the shard, summing every fsdp rank's part.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.parallel import spmd_util
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    Mesh,
)


def llama_param_specs(pipeline: bool = False, moe: bool = False) -> dict:
    """The JAX package's PartitionSpec tree for models.llama's params, as
    tuples: stacked layer weights lead with the layer axis ('pp' with a
    pipeline), and a mixture of experts' MLP weights carry an 'ep'
    axis."""
    layer_axis = "pp" if pipeline else None
    if moe:
        mlp_specs = {
            "w_router": (layer_axis, "fsdp", None),
            "w_gate": (layer_axis, "ep", "fsdp", "tp"),
            "w_up": (layer_axis, "ep", "fsdp", "tp"),
            "w_down": (layer_axis, "ep", "tp", "fsdp"),
        }
    else:
        mlp_specs = {
            "w_gate": (layer_axis, "fsdp", "tp"),
            "w_up": (layer_axis, "fsdp", "tp"),
            "w_down": (layer_axis, "tp", "fsdp"),
        }
    return {
        "embed": ("tp", "fsdp"),
        "layers": {
            "attn_norm": (layer_axis, None),
            "wq": (layer_axis, "fsdp", "tp"),
            "wk": (layer_axis, "fsdp", "tp"),
            "wv": (layer_axis, "fsdp", "tp"),
            "wo": (layer_axis, "tp", "fsdp"),
            "mlp_norm": (layer_axis, None),
            **mlp_specs,
        },
        "final_norm": (None,),
        "lm_head": ("fsdp", "tp"),
    }


def batch_spec(sequence_parallel: bool = False) -> tuple:
    """[B, S] token batches: batch over (dp, fsdp), the sequence over sp
    when enabled."""
    return (BATCH_AXES, "sp" if sequence_parallel else None)


# The JAX package's activation hints by the `kind` its forward passes to
# `constrain`, kept as data: here every activation is a rank's local
# tensor, whose block these specs name.
ACTIVATION_SPECS = {
    "embed_table": lambda sp: ("tp", None),
    "resid": lambda sp: (BATCH_AXES, "sp" if sp else None, None),
    "qkv": lambda sp: (BATCH_AXES, "sp" if sp else None, "tp", None),
    "ff": lambda sp: (BATCH_AXES, "sp" if sp else None, "tp"),
    "logits": lambda sp: (BATCH_AXES, "sp" if sp else None, "tp"),
}


def make_constrain(mesh=None, sequence_parallel: bool = False):
    """The identity `constrain(x, kind)`. In the JAX package it pins an
    activation's layout for GSPMD; here an activation is already the
    rank's own block (ACTIVATION_SPECS says which), so there is no
    layout to hint."""
    return lambda x, kind: x


def param_spec(name: str, moe: bool = False) -> tuple:
    """The spec of a port parameter by its Llama.named_parameters() name
    ('embed', 'layers.3.wq', 'final_norm', 'lm_head'): the JAX spec, a
    layer weight's without its layer entry."""
    specs = llama_param_specs(pipeline=False, moe=moe)
    parts = name.split(".")
    if parts[0] == "layers":
        return specs["layers"][parts[-1]][1:]
    return specs[name]


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_dims(spec: tuple, mesh: Mesh) -> list[tuple[int, tuple]]:
    """[(dim, axes)] of the dims `spec` shards over axes of size > 1."""
    out = []
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in _axes_of(entry) if mesh.axis_size(a) > 1)
        if axes:
            out.append((dim, axes))
    return out


def fsdp_dim(spec: tuple, mesh: Mesh) -> int | None:
    """The dim `spec` shards over fsdp when fsdp > 1, else None."""
    for dim, axes in sharded_dims(spec, mesh):
        if "fsdp" in axes:
            return dim
    return None


def global_shape(local, spec: tuple, mesh: Mesh) -> tuple:
    """The global shape of a tensor from its rank's block under `spec`."""
    shape = list(local)
    for dim, axes in sharded_dims(spec, mesh):
        shape[dim] *= mesh.axis_size(*axes)
    return tuple(shape)


def shard_param(full, spec: tuple, mesh: Mesh):
    """This rank's block of the global tensor `full` under `spec`: along
    each sharded dim, block `mesh.index(*axes)` of that many equal
    blocks. A view where slicing allows; tensors and numpy arrays."""
    out = full
    for dim, axes in sharded_dims(spec, mesh):
        out = spmd_util.block(out, mesh.axis_size(*axes), mesh.index(*axes),
                              dim)
    return out


class GatherShard(torch.autograd.Function):
    """The whole weight in `dtype` from every fsdp rank's shard along
    `dim`; the backward reduce-scatters its f32 gradient to the shard."""

    @staticmethod
    def forward(ctx, shard, dim: int, group, dtype):
        ctx.dim, ctx.group, ctx.shard_dtype = dim, group, shard.dtype
        return spmd_util.gather(shard.to(dtype), dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        full = g.float().movedim(ctx.dim, 0).contiguous()
        out = torch.empty((full.shape[0] // n,) + full.shape[1:],
                          dtype=torch.float32, device=g.device)
        dist.reduce_scatter_tensor(out, full, group=ctx.group)
        return (out.movedim(0, ctx.dim).to(ctx.shard_dtype).contiguous(),
                None, None, None)


def gather_param(shard: torch.Tensor, spec: tuple, mesh: Mesh | None,
                 dtype: torch.dtype) -> torch.Tensor:
    """The whole weight in `dtype` for a layer's use: GatherShard over
    fsdp where `spec` shards it, else the local tensor cast."""
    dim = None if mesh is None else fsdp_dim(spec, mesh)
    if dim is None:
        return shard.to(dtype)
    return GatherShard.apply(shard, dim, mesh.group("fsdp"), dtype)


@torch.no_grad()
def gather_full(shard: torch.Tensor, spec: tuple, mesh: Mesh
                ) -> torch.Tensor:
    """The whole tensor from every rank's block under `spec`, in the
    shard's dtype, with no gradient (checkpoints and tests)."""
    out = shard
    for dim, axes in reversed(sharded_dims(spec, mesh)):
        if len(axes) != 1:
            raise NotImplementedError(f"gather over {axes}")
        out = spmd_util.gather(out, dim, mesh.group(axes[0]))
    return out

