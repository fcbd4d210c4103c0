"""Process-group bootstrap for the collective probes and the fabric
health plane: the JAX package's `parallel/distributed.py`
(`initialize_from_env`) over torch.distributed, plus the one-rank group
a single process probes when nothing launched it as part of a job.

Env contract. torchrun's `MASTER_ADDR`, `MASTER_PORT`, `RANK` and
`WORLD_SIZE` are read first; the JAX package's manifests set
`JAX_COORDINATOR_ADDRESS` (host[:port], default port
`JAX_COORDINATOR_PORT` or 8476), `JAX_NUM_PROCESSES` and
`JAX_PROCESS_ID` (or `JOB_COMPLETION_INDEX`, or the pod name's
ordinal), and the same manifests launch this package. One process is one
rank: where a JAX process holds every chip of its host, a torch rank
holds one card.

Backends. On the card a group is NCCL over CUDA tensors; gloo over CPU
tensors is for runs on the CPU (the tests). Nothing here switches to
gloo when NCCL fails: a caller names its backend, and an NCCL group
without CUDA raises.
"""

from __future__ import annotations

import logging
import os
import re
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = "8476"


def split_host_port(address: str,
                    default_port: str = DEFAULT_COORDINATOR_PORT
                    ) -> tuple[str, str]:
    """(host, port) from a coordinator address: 'host', 'host:port',
    bracketed IPv6 ('[::1]:8476', '[::1]') or a bare IPv6 literal ('::1',
    which cannot carry a port)."""
    if address.startswith("["):
        host, _, rest = address[1:].partition("]")
        port = rest[1:] if rest.startswith(":") else ""
        return host, port or default_port
    if address.count(":") >= 2:
        return address, default_port
    host, sep, port = address.partition(":")
    return host, (port if sep and port else default_port)


def infer_process_id() -> int | None:
    """This process's rank from JAX_PROCESS_ID, JOB_COMPLETION_INDEX
    (Indexed Jobs) or the pod name's ordinal (worker-3)."""
    for var in ("JAX_PROCESS_ID", "JOB_COMPLETION_INDEX"):
        val = os.environ.get(var)
        if val is not None and val.isdigit():
            return int(val)
    m = re.search(r"-(\d+)$", os.environ.get("HOSTNAME", ""))
    return int(m.group(1)) if m else None


def env_rendezvous() -> tuple[str, int, int] | None:
    """(init_method, rank, world_size) from torchrun's variables, else
    from the JAX package's; None where neither names a job."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if addr and port and rank is not None and world is not None:
        return f"tcp://{_url_host(addr)}:{port}", int(rank), int(world)
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num = os.environ.get("JAX_NUM_PROCESSES")
    if not address or not num:
        return None
    host, port = split_host_port(
        address, os.environ.get("JAX_COORDINATOR_PORT",
                                DEFAULT_COORDINATOR_PORT))
    pid = infer_process_id()
    if pid is None:
        raise RuntimeError("JAX_COORDINATOR_ADDRESS set but no process id: "
                           "set JAX_PROCESS_ID or run under an Indexed Job")
    return f"tcp://{_url_host(host)}:{port}", pid, int(num)


def _url_host(host: str) -> str:
    return f"[{host}]" if ":" in host else host


def device_kwargs(backend: str, device) -> dict:
    """NCCL binds its communicator to the card eagerly (device_id); it
    needs CUDA and raises without it."""
    if backend != "nccl":
        return {}
    if not torch.cuda.is_available():
        raise RuntimeError("an NCCL group needs CUDA, and "
                           "torch.cuda.is_available() is False; name the "
                           "gloo backend to run on the CPU")
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return {"device_id": dev}


def initialize_from_env(backend: str = "nccl", device=None) -> bool:
    """init_process_group from the environment (see the module
    docstring). True when this process is (now) part of a group, False
    when no job is configured."""
    if dist.is_initialized():
        return True
    rdv = env_rendezvous()
    if rdv is None:
        return False
    init_method, rank, world = rdv
    log.info("joining %s as rank %d of %d (%s)", init_method, rank, world,
             backend)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            **device_kwargs(backend, device))
    return True


def default_group(backend: str = "nccl", device=None):
    """The process's group: the job's (initialize_from_env), or else a
    one-rank group over an in-process store, on this process's card for
    NCCL. Returns dist.group.WORLD."""
    if not initialize_from_env(backend, device):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1,
                                **device_kwargs(backend, device))
    return dist.group.WORLD


def group_device(group=None) -> torch.device:
    """Where a group's tensors live: the current card for NCCL, the CPU
    otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_rank(group, group_rank: int) -> int:
    """A group rank as the default group numbers it (point-to-point
    calls take those)."""
    if group is None or group is dist.group.WORLD:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def start_cost(group=None) -> dict:
    """What a group costs to bring up: one one-element all-reduce (NCCL
    creates its communicator on the first collective), timed, and the
    card's memory in use before and after (mem_get_info: NCCL's buffers
    lie outside torch's allocator)."""
    dev = group_device(group)
    cuda = dev.type == "cuda"

    def used() -> int:
        if not cuda:
            return 0
        free, total = torch.cuda.mem_get_info(dev)
        return total - free

    before = used()
    t0 = time.perf_counter()
    x = torch.ones(1, device=dev)
    dist.all_reduce(x, group=group)
    if cuda:
        torch.cuda.synchronize(dev)
    return {"backend": dist.get_backend(group),
            "ranks": dist.get_world_size(group),
            "first_collective_s": time.perf_counter() - t0,
            "card_bytes": used() - before}
