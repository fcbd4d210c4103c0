"""The device mesh: the JAX package's parallel/mesh.py over ranks.

Axis convention (outer -> inner), as in the JAX package:
  pp    pipeline parallel (outermost: stages may span slices)
  dp    pure data parallel (the gradient reduction; slices lie along it)
  fsdp  data parallel with sharded params and optimizer state
        (weights all-gathered per layer, gradients reduce-scattered)
  ep    expert parallel
  sp    sequence parallel (ring or Ulysses attention)
  tp    tensor parallel (innermost)

A JAX mesh is one array of devices that one program shards over. Here
each rank is a process holding one device, and a `Mesh` is one rank's
view of the job: the axis sizes, this rank's coordinate on each axis,
one torch.distributed group per axis (the ranks that differ from this
one only along it) plus the groups of a few axis sets, and the rank's
device. Rank r holds the mesh position that the JAX mesh gives device r
(`slice_device_array`, with the dp slices outermost), so a test can hold
the map against the JAX `make_mesh`. An axis of size 1 has no group:
every collective over it is skipped.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "sp", "tp")
# Axis sets with a group of their own besides the single axes: the batch
# (dp, fsdp), the tokens of one step (the batch and sp) and the tokens of
# one dp slice (fsdp, sp).
BATCH_AXES = ("dp", "fsdp")
TOKEN_AXES = ("dp", "fsdp", "sp")
SLICE_TOKEN_AXES = ("fsdp", "sp")
_GROUP_SETS = (BATCH_AXES, TOKEN_AXES, SLICE_TOKEN_AXES)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def total(self) -> int:
        return (self.pp * self.dp * self.fsdp * self.ep * self.sp
                * self.tp)

    def as_tuple(self) -> tuple[int, int, int, int, int, int]:
        return (self.pp, self.dp, self.fsdp, self.ep, self.sp, self.tp)


def auto_axis_sizes(n_devices: int, tp: int | None = None,
                    sp: int | None = None,
                    pp: int | None = None,
                    ep: int | None = None) -> MeshAxes:
    """The JAX package's deterministic factorisation of n_devices: tp up
    to 4 unless given, then fsdp up to 8, the rest to dp; sp, pp and ep
    only as given."""
    rem = n_devices

    def take(target: int | None, cap: int) -> int:
        nonlocal rem
        if target is not None:
            if rem % target:
                raise ValueError(
                    f"axis size {target} does not divide {rem} devices")
            rem //= target
            return target
        got = 1
        while got * 2 <= cap and rem % 2 == 0:
            got *= 2
            rem //= 2
        return got

    tp_sz = take(tp, 4)
    sp_sz = take(sp, 1)
    pp_sz = take(pp, 1)
    ep_sz = take(ep, 1)
    fsdp_sz = take(None, 8)
    dp_sz = rem
    return MeshAxes(pp=pp_sz, dp=dp_sz, fsdp=fsdp_sz, ep=ep_sz,
                    sp=sp_sz, tp=tp_sz)


def slice_device_array(devices, axes: MeshAxes, dcn_slices: int):
    """`devices` (slice-major: each slice's devices contiguous) arranged
    into the (pp, dp, fsdp, ep, sp, tp) shape with the slices along dp,
    so the dp gradient reduction is the only collective that crosses
    slices whatever pp is (the JAX package's factorisation)."""
    n = len(devices)
    if n % dcn_slices:
        raise ValueError(
            f"{n} devices do not split into {dcn_slices} equal slices")
    if axes.dp % dcn_slices:
        raise ValueError(
            f"dp={axes.dp} must be a multiple of dcn_slices="
            f"{dcn_slices}: slices are placed along the dp axis "
            "(mesh.py slice_device_array)")
    per_slice = n // dcn_slices
    inner = axes.pp * (axes.dp // dcn_slices) * axes.fsdp * axes.ep \
        * axes.sp * axes.tp
    if inner != per_slice:
        raise ValueError(
            f"mesh axes {axes} place {inner} devices per slice, but "
            f"{dcn_slices} slices of {per_slice} devices were given")
    arr = np.asarray(devices, dtype=object).reshape(
        dcn_slices, axes.pp, axes.dp // dcn_slices, axes.fsdp, axes.ep,
        axes.sp, axes.tp)
    # (S, pp, dp/S, ...) -> (pp, S, dp/S, ...) -> merge (S, dp/S) = dp.
    arr = np.moveaxis(arr, 0, 1)
    return arr.reshape(axes.as_tuple())


def rank_layout(axes: MeshAxes, dcn_slices: int | None = None
                ) -> np.ndarray:
    """The ranks 0..total-1 in the mesh's shape: layout[coord] is the rank
    at that position, as the JAX make_mesh places device r (row-major;
    with dcn_slices > 1, slice_device_array's order)."""
    ranks = list(range(axes.total))
    if dcn_slices is not None and dcn_slices > 1:
        return slice_device_array(ranks, axes, dcn_slices).astype(np.int64)
    return np.asarray(ranks, dtype=np.int64).reshape(axes.as_tuple())


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh (see the module docstring)."""
    axes: MeshAxes
    rank: int
    coord: dict
    groups: dict
    device: torch.device
    backend: str | None
    layout: np.ndarray

    @property
    def shape(self) -> dict:
        """{axis: size}, the JAX Mesh.shape form."""
        return dict(zip(AXIS_NAMES, self.axes.as_tuple()))

    @property
    def size(self) -> int:
        return self.axes.total

    def axis_size(self, *names: str) -> int:
        out = 1
        for name in names:
            out *= getattr(self.axes, name)
        return out

    def index(self, *names: str) -> int:
        """This rank's coordinate along the axes `names` taken together,
        the first outermost (the JAX package's combined-axis order)."""
        idx = 0
        for name in names:
            idx = idx * getattr(self.axes, name) + self.coord[name]
        return idx

    def group(self, *names: str):
        """The process group of the ranks that differ from this one only
        along `names` (one axis, or one of the sets of _GROUP_SETS); None
        where those axes hold one rank."""
        key = names[0] if len(names) == 1 else tuple(names)
        if self.axis_size(*names) == 1:
            return None
        return self.groups[key]


def _axis_groups(layout: np.ndarray, names: tuple[str, ...]):
    """Every group of ranks that differ only along `names`, in one order
    every rank computes alike: [(ranks,...), ...]."""
    dims = [AXIS_NAMES.index(n) for n in names]
    others = [d for d in range(layout.ndim) if d not in dims]
    moved = np.moveaxis(layout, dims + others, list(range(layout.ndim)))
    inner = int(np.prod([layout.shape[d] for d in dims]))
    flat = moved.reshape(inner, -1)
    return [tuple(int(r) for r in flat[:, j]) for j in range(flat.shape[1])]


def make_mesh(axes: MeshAxes | None = None, *,
              dcn_slices: int | None = None, device=None) -> Mesh:
    """This rank's Mesh over the job's world (torch.distributed's default
    group, or one process when none is initialized). `axes=None`
    factors the world by auto_axis_sizes; the axes must cover exactly
    the world. Every rank calls this once, in the same order as its
    other group creations: each group is made with dist.new_group by
    every rank of the job. `device` is this rank's; without it, the
    current card for NCCL (or for one process with CUDA), else the
    CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if axes is None:
        axes = auto_axis_sizes(world)
    if axes.total != world:
        raise ValueError(
            f"mesh axes {axes} need {axes.total} ranks, have {world}")
    layout = rank_layout(axes, dcn_slices)
    pos = np.argwhere(layout == rank)[0]
    coord = {name: int(c) for name, c in zip(AXIS_NAMES, pos)}
    backend = dist.get_backend() if dist.is_initialized() else None
    if device is None:
        if backend == "nccl" or (backend is None
                                 and torch.cuda.is_available()):
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
    groups: dict = {}
    for names in [(n,) for n in AXIS_NAMES] + list(_GROUP_SETS):
        key = names[0] if len(names) == 1 else names
        size = int(np.prod([getattr(axes, n) for n in names]))
        if size == 1:
            continue
        for ranks in _axis_groups(layout, names):
            g = dist.new_group(list(ranks))
            if rank in ranks:
                groups[key] = g
                # A group numbers its ranks in ascending global order,
                # which the layout keeps along every axis set here: a
                # rank's group rank is its coordinate there.
                want = int(np.ravel_multi_index(
                    [coord[n] for n in names],
                    [getattr(axes, n) for n in names]))
                if dist.get_rank(g) != want:
                    raise AssertionError(
                        f"group {names}: rank {dist.get_rank(g)}, "
                        f"coordinate {want}")
    return Mesh(axes=axes, rank=rank, coord=coord, groups=groups,
                device=torch.device(device), backend=backend,
                layout=layout)


def single_mesh(device) -> Mesh:
    """The one-rank mesh of a process that is not part of a job."""
    axes = MeshAxes()
    return Mesh(axes=axes, rank=0, coord={n: 0 for n in AXIS_NAMES},
                groups={}, device=torch.device(device), backend=None,
                layout=np.zeros(axes.as_tuple(), dtype=np.int64))


def coordinates(axes: MeshAxes, dcn_slices: int | None = None
                ) -> list[dict]:
    """Each rank's coordinate, by rank: what make_mesh gives rank r."""
    layout = rank_layout(axes, dcn_slices)
    out = [None] * axes.total
    for pos in itertools.product(*(range(s) for s in axes.as_tuple())):
        out[int(layout[pos])] = dict(zip(AXIS_NAMES, (int(p) for p in pos)))
    return out
