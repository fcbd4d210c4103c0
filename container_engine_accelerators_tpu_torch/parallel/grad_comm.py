"""Bucketed dp gradient reduction with optional int8 compression, the
JAX package's parallel/grad_comm.py over ranks.

The slices of a multislice job lie along the mesh's dp axis
(parallel/mesh.py), so the dp gradient reduction is the one collective
that crosses slices. The JAX package leaves its timing to XLA's
scheduler inside one jit; here the reducer issues it:

  1. The gradient leaves are packed into size-targeted buckets in
     reverse flatten order (lm_head first: the backward finishes those
     first), by the JAX package's `partition_buckets` on the global
     leaf shapes, so both packages bucket alike.
  2. A post-accumulate-grad hook on every leaf counts the bucket's
     leaves down on the last microbatch; when a bucket's gradients all
     exist, its reduction is launched at once as ONE flat collective
     over the dp group with async_op=True, while the backward carries
     on. `finish` waits for every bucket before the optimizer step.
  3. compress='int8': each rank quantizes its own slot (its slice's
     gradient plus the error carried from the last step,
     ops/quant.quantize_grads), the int8 values and f32 scales are
     all-gathered over dp (a quarter of the f32 bytes), and the mean is
     taken locally after dequantization with 1/(n_slices * grad_accum)
     folded into the scales. The quantization error is the next step's
     error feedback (`init_error_feedback`, TrainState.dcn_ef).

A gradient leaf here is a rank's fsdp shard: GatherShard's backward has
already reduce-scattered it over fsdp. A leaf replicated over fsdp (the
norms) is first all-reduced over fsdp, so every leaf entering the dp
reduction is its slice's whole gradient, as the JAX reducer's stacked
leaves are. An int8 scale reduces over dims an fsdp shard splits, so its
absmax is all-reduced (max) over fsdp, as GSPMD reduces it there.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Sequence

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.ops.quant import (
    dequantize_grads,
    grad_chunks,
    quantize_grads,
)
from container_engine_accelerators_tpu_torch.parallel import sharding

COMPRESS_MODES = ("none", "int8")

# 4 MiB of a slice's f32 gradient a bucket (MegaScale and DDP both use
# 1-25 MiB): enough to amortize a collective's latency, small enough that
# the first bucket leaves long before the backward ends.
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class DcnOverlapConfig:
    """bucket_bytes: target bucket payload (a slice's f32 bytes).
    compress: 'none' (f32 wire) or 'int8' (quantized wire + error
    feedback in TrainState.dcn_ef). axis: the mesh axis reduced over."""
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    compress: str = "none"
    axis: str = "dp"

    def __post_init__(self):
        if self.compress not in COMPRESS_MODES:
            raise ValueError(
                f"compress={self.compress!r} not in {COMPRESS_MODES}")
        if self.bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be positive")


def _leaf_bytes(leaf) -> int:
    """A slice's f32 payload of one leaf (anything with a .shape)."""
    return int(math.prod(leaf.shape)) * 4


def partition_buckets(leaves: Sequence,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES
                      ) -> list[list[int]]:
    """Greedy packing in REVERSE flatten order: leaves join a bucket
    until it would pass `bucket_bytes`; a leaf larger than the target
    gets a bucket of its own (a leaf is never split). Returns buckets of
    original leaf indices, each index exactly once."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for idx in reversed(range(len(leaves))):
        nbytes = _leaf_bytes(leaves[idx])
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(idx)
        cur_bytes += nbytes
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _scale_count(stacked_shape: tuple[int, ...]) -> int:
    """The f32 scales quantize_grads makes for a stacked leaf."""
    ndim = len(stacked_shape)
    if ndim <= 1:
        return 1
    if ndim == 2:
        return stacked_shape[0]
    return stacked_shape[0] * stacked_shape[-1]


def leaf_wire_bytes(leaf, n_slices: int, compress: str) -> int:
    """Bytes one leaf puts on the dp wire a step: 'none' the f32
    all-reduce payload (nccl-tests' size), 'int8' the all-gathered int8
    values of every slot plus their f32 scales."""
    per_slice = int(math.prod(leaf.shape))
    if compress == "none":
        return per_slice * 4
    stacked = (n_slices,) + tuple(leaf.shape)
    return per_slice * n_slices + _scale_count(stacked) * 4


def wire_bytes(leaves: Sequence, n_slices: int, compress: str) -> int:
    return sum(leaf_wire_bytes(lf, n_slices, compress) for lf in leaves)


class _Leaf:
    """One gradient leaf of the JAX package's tree: a weight, or one
    layer weight stacked over the layers ([L, ...]), as its members'
    indices into the reducer's params."""

    def __init__(self, key: str, members: list[int], spec: tuple,
                 shape: tuple, local: tuple, stacked: bool):
        self.key, self.members, self.spec = key, members, spec
        self.shape, self.local, self.stacked = shape, local, stacked


def jax_leaves(names: Sequence[str], params: Sequence[torch.Tensor], mesh,
               moe: bool = False) -> list[_Leaf]:
    """The model's parameters grouped as the JAX package's param tree
    flattens (sorted keys; each layer weight one leaf stacked over the
    layers), with global shapes."""
    groups: dict[str, list[int]] = {}
    for i, name in enumerate(names):
        parts = name.split(".")
        key = f"layers/{parts[-1]}" if parts[0] == "layers" else name
        groups.setdefault(key, []).append(i)
    order = sorted(groups, key=lambda k: (k.split("/")[0], k))
    leaves = []
    for key in order:
        members = groups[key]
        spec = sharding.param_spec(names[members[0]], moe)
        local = tuple(params[members[0]].shape)
        shape = sharding.global_shape(local, spec, mesh)
        stacked = key.startswith("layers/")
        if stacked:
            shape, local = (len(members),) + shape, (len(members),) + local
        leaves.append(_Leaf(key, members, spec, shape, local, stacked))
    return leaves


class BucketReducer:
    """The bucketed dp reduction of one model's gradients (see the module
    docstring). `named` is the model's named_parameters(); its leaves are
    grouped and bucketed as the JAX package's tree (jax_leaves), so both
    packages bucket, scale and count wire bytes alike. `denom` is the
    mean's n_slices * grad_accum. `attach` registers the hooks; each step
    calls `arm(final)` before every microbatch's backward and `finish()`
    after the last, before the optimizer step."""

    def __init__(self, mesh, named: Sequence[tuple[str, torch.Tensor]],
                 cfg: DcnOverlapConfig, denom: float, moe: bool = False,
                 error_feedback: dict | None = None):
        self.mesh = mesh
        self.cfg = cfg
        self.n_slices = mesh.axis_size(cfg.axis)
        self.group = mesh.group(cfg.axis)
        self.denom = float(denom)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.leaves = jax_leaves(self.names, self.params, mesh, moe)
        self.buckets = partition_buckets(self.leaves, cfg.bucket_bytes)
        self.wire_bytes = wire_bytes(self.leaves, self.n_slices,
                                     cfg.compress)
        self.bucket_wire_bytes = [
            sum(leaf_wire_bytes(self.leaves[i], self.n_slices, cfg.compress)
                for i in b) for b in self.buckets]
        self._bucket_of = {m: b for b, idx in enumerate(self.buckets)
                           for i in idx for m in self.leaves[i].members}
        self._members = [sum(len(self.leaves[i].members) for i in idx)
                         for idx in self.buckets]
        self.ef = error_feedback
        self._final = False
        self._pending: list[int] = []
        self._works: list = []
        self._hooks: list = []

    # ---------- hooks ----------

    def attach(self) -> "BucketReducer":
        # The hooks reach the reducer through a weak reference. The
        # garbage collector does not follow a parameter's hooks, so a
        # strong one would keep the reducer and its model alive for
        # good once a train step dropped it without detach(); this way
        # both are freed, and the hooks left behind do nothing.
        ref = weakref.ref(self)

        def on_grad(i: int) -> None:
            reducer = ref()
            if reducer is not None:
                reducer._on_grad(i)

        for i, p in enumerate(self.params):
            self._hooks.append(p.register_post_accumulate_grad_hook(
                lambda _p, i=i: on_grad(i)))
        return self

    def detach(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def arm(self, final: bool) -> None:
        """Before a microbatch's backward: launch buckets during it only
        when it is the step's last."""
        self._final = final
        if final:
            self._pending = list(self._members)
            self._works = []

    def _on_grad(self, i: int) -> None:
        if not self._final:
            return
        b = self._bucket_of[i]
        self._pending[b] -= 1
        if self._pending[b] == 0:
            self._works.append(self._launch(b))

    # ---------- one bucket ----------

    def _grad(self, leaf: _Leaf) -> torch.Tensor:
        gs = [self.params[m].grad.float() for m in leaf.members]
        return torch.stack(gs) if leaf.stacked else gs[0]

    def _set_grad(self, leaf: _Leaf, value: torch.Tensor) -> None:
        if not leaf.stacked:
            value = value[None]
        for m, v in zip(leaf.members, value):
            self.params[m].grad.copy_(v)

    def _absmax_of(self, leaf: _Leaf):
        """The int8 scale's absmax over the whole leaf: an all-reduce
        (max) over fsdp where the scale's reduced dims include the dim
        the shard splits."""
        dim = sharding.fsdp_dim(leaf.spec, self.mesh)
        if dim is None:
            return None
        ndim = 1 + len(leaf.local)                 # with the slot axis
        dim += 1 + int(leaf.stacked)
        if ndim <= 2 or dim == ndim - 1:
            return None
        group = self.mesh.group("fsdp")

        def absmax_of(a):
            a = a.contiguous()
            dist.all_reduce(a, op=dist.ReduceOp.MAX, group=group)
            return a
        return absmax_of

    def _launch(self, b: int):
        """Start bucket b's reduction; returns what finish needs."""
        leaves = [self.leaves[i] for i in self.buckets[b]]
        fsdp = self.mesh.group("fsdp")
        for leaf in leaves:
            if fsdp is not None and sharding.fsdp_dim(
                    leaf.spec, self.mesh) is None:
                for m in leaf.members:
                    dist.all_reduce(self.params[m].grad, group=fsdp)
        if self.cfg.compress == "none":
            members = [m for lf in leaves for m in lf.members]
            if len(members) == 1:
                # One weight: its gradient is the buffer, reduced in place.
                flat = self.params[members[0]].grad.view(-1)
            else:
                flat = torch.cat([self._grad(lf).reshape(-1)
                                  for lf in leaves])
            work = (None if self.group is None else
                    dist.all_reduce(flat, group=self.group, async_op=True))
            return (b, work, flat)
        qs, scales, s_shapes = [], [], []
        for leaf in leaves:
            if self.ef is None:
                c = self._grad(leaf)
            elif leaf.stacked:
                c = self._grad(leaf) + torch.stack(
                    [self.ef[self.names[m]] for m in leaf.members])
            else:
                # The carried error becomes the quantized sum and then
                # the new error, in its own memory.
                c = self.ef[self.names[leaf.members[0]]].add_(
                    self._grad(leaf))
            q, sc = quantize_grads(c[None], self._absmax_of(leaf))
            if self.ef is not None:
                c1, q1 = c[None], q
                for sl in grad_chunks(c1):
                    scale = sc if sc.ndim < 2 or sc.shape[1] == 1 \
                        else sc[:, sl]
                    c1[:, sl].sub_(dequantize_grads(q1[:, sl], scale))
                if leaf.stacked:
                    for m, e in zip(leaf.members, c):
                        self.ef[self.names[m]] = e
            qs.append(q.reshape(-1))
            scales.append(sc.reshape(-1))
            s_shapes.append(tuple(sc.shape[1:]))
        q_flat, s_flat = torch.cat(qs), torch.cat(scales)
        if self.group is None:
            return (b, None, (q_flat[None], s_flat[None], s_shapes))
        q_all = torch.empty((self.n_slices * q_flat.numel(),),
                            dtype=torch.int8, device=q_flat.device)
        s_all = torch.empty((self.n_slices * s_flat.numel(),),
                            dtype=torch.float32, device=s_flat.device)
        works = (dist.all_gather_into_tensor(q_all, q_flat, group=self.group,
                                             async_op=True),
                 dist.all_gather_into_tensor(s_all, s_flat, group=self.group,
                                             async_op=True))
        return (b, works, (q_all.view(self.n_slices, -1),
                           s_all.view(self.n_slices, -1), s_shapes))

    def _unpack(self, b: int, payload) -> None:
        leaves = [self.leaves[i] for i in self.buckets[b]]
        inv = 1.0 / self.denom
        if self.cfg.compress == "none":
            if payload.data_ptr() == self.params[
                    leaves[0].members[0]].grad.data_ptr():
                payload.mul_(inv)
                return
            off = 0
            for leaf in leaves:
                n = math.prod(leaf.local)
                self._set_grad(leaf, (payload[off:off + n] * inv).view(
                    leaf.local))
                off += n
            return
        q_all, s_all, s_shapes = payload
        qoff = soff = 0
        for leaf, s_shape in zip(leaves, s_shapes):
            n, n_s = math.prod(leaf.local), math.prod(s_shape)
            q = q_all[:, qoff:qoff + n].reshape((-1,) + leaf.local)
            sc = s_all[:, soff:soff + n_s].reshape((-1,) + s_shape)
            # The slots' sum in slot order, one slot's f32 at a time,
            # into the gradient itself where the leaf is one weight.
            mean = (self.params[leaf.members[0]].grad if not leaf.stacked
                    else torch.empty(leaf.local, dtype=torch.float32,
                                     device=q.device))
            torch.mul(q[0], sc[0] * inv, out=mean)
            for i in range(1, q.shape[0]):
                mean += dequantize_grads(q[i], sc[i], scale=inv)
            if leaf.stacked:
                self._set_grad(leaf, mean)
            qoff += n
            soff += n_s

    def finish(self, launch_rest: bool = True) -> None:
        """Wait for the buckets' reductions and write the reduced means
        into .grad; with `launch_rest`, first launch, in bucket order,
        every bucket no hook launched."""
        launched = {w[0] for w in self._works}
        for b in range(len(self.buckets)):
            if launch_rest and b not in launched:
                self._works.append(self._launch(b))
        for b, work, payload in self._works:
            for w in (work if isinstance(work, tuple) else (work,)):
                if w is not None:
                    w.wait()
            self._unpack(b, payload)
        self._works = []
        self._final = False


def init_error_feedback(named: Sequence[tuple[str, torch.Tensor]],
                        cfg: DcnOverlapConfig) -> dict | None:
    """The error-feedback accumulator: zeros shaped like each local
    leaf, f32, one slot per dp slice (this rank's); None for
    compress='none'."""
    if cfg.compress != "int8":
        return None
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named}


def validate_mesh_for_overlap(mesh, cfg: DcnOverlapConfig,
                              sequence_parallel: bool = False) -> None:
    """The overlapped reduction composes with dp and fsdp only, as in the
    JAX package: refuse rather than mis-shard."""
    if cfg.axis not in mesh.shape:
        raise ValueError(f"mesh has no {cfg.axis!r} axis: {mesh.shape}")
    for ax in ("pp", "sp", "ep"):
        if mesh.shape.get(ax, 1) > 1:
            raise ValueError(
                f"dcn_overlap does not compose with {ax}>1 yet "
                f"(mesh {mesh.shape})")
    if sequence_parallel:
        raise ValueError("dcn_overlap does not compose with "
                         "sequence_parallel yet")


# ---------- exposed-communication attribution ----------
#
# Three probes over the same machinery, timed after the first step:
#   compute   the gradients alone (no dp reduction)
#   full      the gradients and the bucketed reduction
#   bucket_i  bucket i's reduction alone, on those gradients
# exposed = t(full) - t(compute) is the reduction the backward did not
# hide; the buckets' sum is its serial cost; overlap_fraction =
# 1 - exposed / serial; busBW = wire bytes / serial. On the card each is
# timed with CUDA events, on the CPU with the host clock. The probes run
# after the step that warmed every path, so none is warmed again: over
# gloo each bucket costs its bytes' trip through the host.


class AttributionProbes:
    """`grads_fn(reducer_or_None)` runs one step's forward and backward
    (arming `reducer` when given, none of its state kept) and returns
    nothing; `make_reducer()` builds a reducer over scratch error
    feedback, so the probes leave the train state as it was."""

    def __init__(self, make_reducer, grads_fn, device: torch.device):
        self.make_reducer = make_reducer
        self.grads_fn = grads_fn
        self.device = device

    def _timed(self, fn, iters: int) -> float:
        times = []
        for _ in range(iters):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    def calibrate(self, iters: int = 1) -> dict:
        reducer = self.make_reducer()

        def full():
            self.grads_fn(reducer)
            reducer.finish()

        t_compute = self._timed(lambda: self.grads_fn(None), iters)
        t_full = self._timed(full, iters)
        self.grads_fn(None)
        saved = [p.grad.clone() for p in reducer.params]
        bucket_s = []
        for b in range(len(reducer.buckets)):
            def one(b=b):
                for p, g in zip(reducer.params, saved):
                    p.grad.copy_(g)
                reducer._works = [reducer._launch(b)]
                reducer.finish(launch_rest=False)
            bucket_s.append(self._timed(one, iters))
        reducer.detach()
        t_reduce = sum(bucket_s)
        exposed = max(t_full - t_compute, 0.0)
        if t_reduce > 0:
            overlap_fraction = min(max(1.0 - exposed / t_reduce, 0.0), 1.0)
            busbw = reducer.wire_bytes / t_reduce
        else:
            overlap_fraction, busbw = 1.0, 0.0
        return {
            "overlap_fraction": round(overlap_fraction, 4),
            "exposed_s_per_step": exposed,
            "reduce_s_per_step": t_reduce,
            "compute_s_per_step": t_compute,
            "full_s_per_step": t_full,
            "bucket_ms": [round(s * 1e3, 4) for s in bucket_s],
            "busbw_bytes_per_second": busbw,
            **summarize(reducer),
        }


def summarize(reducer: BucketReducer) -> dict:
    """JSON-able description for the step log and the smoke."""
    return {
        "n_buckets": len(reducer.buckets),
        "bucket_bytes_target": reducer.cfg.bucket_bytes,
        "compress": reducer.cfg.compress,
        "axis": reducer.cfg.axis,
        "n_slices": reducer.n_slices,
        "wire_bytes_per_step": reducer.wire_bytes,
        "bucket_wire_bytes": list(reducer.bucket_wire_bytes),
        "bucket_sizes": [len(b) for b in reducer.buckets],
    }
