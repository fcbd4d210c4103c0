"""Collective bandwidth probes over torch.distributed: the JAX package's
`ops/collectives.py` (there `jax.lax` collectives under shard_map over a
mesh axis), with nccl-tests' busBW accounting so numbers compare across
fabrics.

Where JAX takes a Mesh and an axis name, these take a process group and
the axis name that labels it. Each probe maps this rank's shard (a 1-D
tensor of `elems` elements, `elems` a multiple of the group's size n)
through one collective:

  all_reduce      dist.all_reduce, in place (the probe's input is
                  zeros, as JAX's is, so repeated calls leave it zeros)
  all_gather      dist.all_gather_into_tensor -> [n * elems]
  reduce_scatter  dist.reduce_scatter_tensor -> [elems / n]
  all_to_all      dist.all_to_all_single: chunk j of the result is
                  chunk <rank> of rank j's shard
  ppermute        the ring i -> i + 1 with dist.batch_isend_irecv; at
                  n = 1, JAX's identity permutation [(0, 0)], which
                  point-to-point calls refuse (a peer equal to the
                  caller's rank), so the buffer goes through the group
                  with dist.all_to_all_single (NCCL runs it as a device
                  copy)

busBW factors follow the nccl-tests convention:
  all_reduce:     busBW = algBW * 2 * (n-1) / n
  all_gather:     busBW = algBW * (n-1) / n      (size = full gathered bytes)
  reduce_scatter: busBW = algBW * (n-1) / n
  all_to_all:     busBW = algBW * (n-1) / n
  ppermute (ring sendrecv): busBW = algBW
At n = 1 (one card) the first four read 0 by construction and only
ppermute reads the copy's rate, as JAX's do on one chip.

Labels. `axis_fabric` keeps JAX's values, 'ici' and 'dcn', so the
doctor, the fleet plane and the fabric report read these rows unchanged:
here 'ici' means the card itself or NVLink between cards of one host,
and 'dcn' a dp group that spans hosts.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.parallel.distributed import (
    global_rank,
    group_device,
)


@dataclasses.dataclass(frozen=True)
class CollectiveResult:
    collective: str
    size_bytes: int          # nccl-tests "size" column
    time_us: float           # mean per-iteration latency
    alg_bw_gbps: float       # GB/s
    bus_bw_gbps: float       # GB/s

    def row(self) -> str:
        return (f"{self.collective:>16} {self.size_bytes:>12} "
                f"{self.time_us:>10.1f} {self.alg_bw_gbps:>8.2f} "
                f"{self.bus_bw_gbps:>8.2f}")


def hosts() -> int:
    """Hosts the job spans: torchrun's WORLD_SIZE over LOCAL_WORLD_SIZE
    (one host where either is unset)."""
    world = int(os.environ.get("WORLD_SIZE") or 1)
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or world)
    return max(1, world // max(local, 1))


def axis_fabric(axis: str) -> str:
    """Which fabric a collective over this axis rides: 'dcn' for the dp
    axis of a job that spans hosts (the host NICs), else 'ici' (the card
    or NVLink). Read at each call: a hook built before the job's group
    exists must not keep a stale label."""
    if axis == "dp" and hosts() > 1:
        return "dcn"
    return "ici"


_BUS_FACTORS: dict[str, Callable[[int], float]] = {
    "all_reduce": lambda n: 2 * (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reduce_scatter": lambda n: (n - 1) / n,
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
}

COLLECTIVES = tuple(_BUS_FACTORS)


def _ring(group, n: int):
    """ppermute over the ring i -> i + 1 of `group`."""
    if n == 1:
        def copy(x):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return out
        return copy
    me = dist.get_rank(group)
    to = global_rank(group, (me + 1) % n)
    frm = global_rank(group, (me - 1) % n)

    def ring(x):
        out = torch.empty_like(x)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, to, group),
                dist.P2POp(dist.irecv, out, frm, group)]):
            work.wait()
        return out
    return ring


def _collective_fn(name: str, group, n: int):
    """fn(shard) -> this rank's result, shard 1-D [elems]."""
    if name == "all_reduce":
        def all_reduce(x):
            dist.all_reduce(x, group=group)
            return x
        return all_reduce
    if name == "all_gather":
        def all_gather(x):
            out = x.new_empty(x.numel() * n)
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        return all_gather
    if name == "reduce_scatter":
        def reduce_scatter(x):
            out = x.new_empty(x.numel() // n)
            dist.reduce_scatter_tensor(out, x, group=group)
            return out
        return reduce_scatter
    if name == "all_to_all":
        def all_to_all(x):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return out
        return all_to_all
    if name == "ppermute":
        return _ring(group, n)
    raise ValueError(f"unknown collective {name!r}")


def build_probe(group, axis: str, collective: str):
    """(fn, n): fn maps this rank's [elems] shard through the collective
    once per call over `group` (n ranks), labelled `axis`."""
    n = dist.get_world_size(group)
    return _collective_fn(collective, group, n), n


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graphed(fn, x: torch.Tensor, iters: int):
    """(graph, start, end): `iters` calls of fn(x) captured as one CUDA
    graph between two timing events recorded inside it (external events:
    a replay timestamps them on the card), so the events' time is the
    collectives' alone, back to back, with no host time in it. Captured
    once per (buffer size, dtype, iters) and kept on the probe with the
    zeroed buffer it reads; one eager call on a side stream first keeps
    NCCL's and the allocator's setup out of the capture."""
    key = (x.numel(), x.dtype, iters)
    graphs = fn.__dict__.setdefault("graphs", {})
    if key not in graphs:
        buf = torch.zeros_like(x)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            fn(buf)
        torch.cuda.current_stream(x.device).wait_stream(side)
        start, end = (torch.cuda.Event(enable_timing=True, external=True)
                      for _ in "se")
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a memory poller's
        # mem_get_info) neither break the capture nor are caught in it.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            start.record()
            for _ in range(iters):
                fn(buf)
            end.record()
        graph.replay()   # the first replay uploads the graph
        graphs[key] = (graph, start, end, buf)   # the graph reads buf
    return graphs[key][:3]


def probe_collective(group, axis: str, collective: str, size_bytes: int,
                     warmup: int = 5, iters: int = 20,
                     dtype=torch.float32, prebuilt=None,
                     pre_delay_s: float = 0.0) -> CollectiveResult:
    """Time one collective at one per-rank size over `group`.

    nccl-tests' `-w 5 --iters N` discipline, as JAX's: warmup runs
    excluded, the card synchronised before t0 and after the timed loop
    (CUDA launches return before the work is done). `prebuilt` takes a
    cached build_probe(...) result; `pre_delay_s` sleeps INSIDE the
    timed window (the fabric-slow chaos hook: in a job of several ranks
    a matched collective drags every participant, as a slow peer would).

    The window: on the CPU (gloo) the wall clock from t0, as JAX's. On
    the card the timed loop is one CUDA graph replay (_graphed), and the
    window is the sleep plus the time between the two CUDA events the
    graph records around the collectives: the card's host stalls for 2-5
    ms at random (a wall-clock probe read 2-6x its copy's time in one
    sweep in five, idle), while a 64 MiB copy through the group takes
    ~50 us and a 16 KiB one a few, so a wall-clock window would time the
    host, not the fabric."""
    fn, n = prebuilt if prebuilt is not None else build_probe(
        group, axis, collective)
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = max(size_bytes // itemsize, n)
    elems -= elems % n  # each rank's shard divides evenly for a2a/scatter

    dev = group_device(group)
    x = torch.zeros(elems, dtype=dtype, device=dev)
    for _ in range(warmup):
        fn(x)
    cuda = dev.type == "cuda"
    if cuda:
        graph, start, end = _graphed(fn, x, iters)
    _fence(dev)

    m0 = time.monotonic()
    t0 = time.perf_counter()
    if pre_delay_s > 0:
        time.sleep(pre_delay_s)
    if cuda:
        graph.replay()
    else:
        for _ in range(iters):
            fn(x)
    _fence(dev)
    if cuda:
        # An all-reduce of one rank leaves the graph nothing but the
        # events: floor their time at the events' resolution.
        dt = (max(pre_delay_s, 0.0)
              + max(start.elapsed_time(end), 5e-4) / 1e3) / iters
    else:
        dt = (time.perf_counter() - t0) / iters

    per_rank_bytes = elems * itemsize
    size = per_rank_bytes * n if collective == "all_gather" \
        else per_rank_bytes
    alg_bw = size / dt / 1e9
    bus_bw = alg_bw * _BUS_FACTORS[collective](n)
    # The timed window as an X span and a busBW counter sample, one
    # series per (collective, axis, fabric): a dp/DCN all-reduce must
    # never overwrite the tp series on a merged timeline.
    if events.enabled():
        fabric = axis_fabric(axis)
        events.complete(f"fabric/probe/{collective}", m0,
                        time.monotonic() - m0, "fabric",
                        {"axis": axis, "fabric": fabric,
                         "size_bytes": size,
                         "time_us": round(dt * 1e6, 1),
                         "bus_bw_gbps": round(bus_bw, 3)})
        events.counter("fabric/busbw_gbps",
                       {f"{collective}.{axis}.{fabric}":
                        round(bus_bw, 3)})
    return CollectiveResult(collective, size, dt * 1e6, alg_bw, bus_bw)


def sweep(group, axis: str, collective: str,
          begin_bytes: int = 1 << 20, end_bytes: int = 1 << 29,
          factor: int = 2, warmup: int = 5, iters: int = 20,
          dtype=torch.float32) -> list[CollectiveResult]:
    """`-b 1M -e 512M -f 2` sweep, one CollectiveResult per size."""
    results = []
    prebuilt = build_probe(group, axis, collective)
    size = begin_bytes
    while size <= end_bytes:
        results.append(probe_collective(group, axis, collective, size,
                                        warmup=warmup, iters=iters,
                                        dtype=dtype, prebuilt=prebuilt))
        size *= factor
    return results


def make_probe_hook(group, axis: str,
                    collectives=("all_reduce", "all_gather"),
                    size_bytes: int = 1 << 20, warmup: int = 2,
                    iters: int = 5):
    """A low-rate background-probe callable for
    FabricMetricServer(collective_probe=...): each call times the given
    collectives once at one small size and returns
    [(collective, axis, fabric, busbw_bytes_per_second), ...] for the
    `fabric_collective_busbw_bytes_per_second` family. The fabric label
    is read at each call (axis_fabric)."""

    def hook():
        fabric = axis_fabric(axis)
        out = []
        for c in collectives:
            r = probe_collective(group, axis, c, size_bytes,
                                 warmup=warmup, iters=iters)
            out.append((c, axis, fabric, r.bus_bw_gbps * 1e9))
        return out

    return hook


def report(results: list[CollectiveResult]) -> str:
    header = (f"{'collective':>16} {'bytes':>12} {'us':>10} "
              f"{'algbw GB/s':>10} {'busbw GB/s':>10}")
    lines = [header] + [r.row() for r in results]
    peak = max((r.bus_bw_gbps for r in results), default=0.0)
    lines.append(f"# peak busBW {peak:.2f} GB/s")
    return "\n".join(lines)
