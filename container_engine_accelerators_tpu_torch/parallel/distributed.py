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

Placement. A tensor-parallel serving group (`TPGroup`,
models/decode_tp.py) and a training job's world (`initialize_from_env`
with a device, parallel/mesh.py) place their ranks by one rule,
`choose_placement`, read from each host's own view: where every host
shows at least as many cards as it runs ranks, a rank takes
`cuda:<its index among its host's ranks>` over NCCL; where one shows
fewer, the ranks of a job on one host share `cuda:0` over gloo, each
holding only its own shard there (gloo takes CUDA tensors and stages
them through the host), and a job across hosts is refused rather than
stacked on one card; on the CPU, when the caller asks for it, the ranks
use gloo. A serving group lives on one host (`placement`); a job learns
its hosts from torchrun's `LOCAL_WORLD_SIZE`, or else by each rank
posting its host name and card count to the coordinator's store before
the group forms. The backend follows from the placement and is never a
fallback. The group's collectives time out after `timeout_s` seconds.

Coordinator. `JAX_COORDINATOR_TIMEOUT_S` (default 300) bounds a rank's
wait for the coordinator: a rank other than 0 first probes the address
over TCP, and a coordinator that never answers raises
`CoordinatorConnectError` naming the address and the rank within that
time, never a hang. `num_slices` reads the job's DCN slice count
(`MEGASCALE_NUM_SLICES`, then `JAX_NUM_SLICES`), which cli/train.py
places along the mesh's dp axis.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = "8476"
DEFAULT_COORDINATOR_TIMEOUT_S = 300.0

# (backend, device) of the job initialize_from_env joined.
_PLACED: tuple[str, torch.device] | None = None


class CoordinatorConnectError(RuntimeError):
    """The job's coordinator did not answer within the timeout; names
    the address and this process's rank, so the failing pod's log says
    which endpoint to debug."""

    def __init__(self, address: str, process_id: int, num_processes: int,
                 timeout_s: float, cause: BaseException):
        self.address = address
        self.process_id = process_id
        self.num_processes = num_processes
        self.timeout_s = timeout_s
        super().__init__(
            f"torch.distributed initialization failed: coordinator "
            f"{address} unreachable from process "
            f"{process_id}/{num_processes} within {timeout_s:.0f}s "
            f"(JAX_COORDINATOR_TIMEOUT_S). Is the coordinator pod "
            f"(rank 0) running and the address routable? "
            f"Underlying error: {type(cause).__name__}: "
            f"{str(cause)[:300]}")


def num_slices(default: int = 1) -> int:
    """The job's DCN slice count: MEGASCALE_NUM_SLICES, then
    JAX_NUM_SLICES, else `default`."""
    for var in ("MEGASCALE_NUM_SLICES", "JAX_NUM_SLICES"):
        val = os.environ.get(var)
        if val is not None and val.isdigit():
            return max(1, int(val))
    return default


def coordinator_timeout_s() -> float:
    try:
        return float(os.environ.get("JAX_COORDINATOR_TIMEOUT_S",
                                    DEFAULT_COORDINATOR_TIMEOUT_S))
    except ValueError:
        log.warning("malformed JAX_COORDINATOR_TIMEOUT_S=%r; using %gs",
                    os.environ.get("JAX_COORDINATOR_TIMEOUT_S"),
                    DEFAULT_COORDINATOR_TIMEOUT_S)
        return DEFAULT_COORDINATOR_TIMEOUT_S


def probe_coordinator(host: str, port: str, process_id: int,
                      num_processes: int, timeout_s: float) -> None:
    """A bounded TCP probe of the coordinator before joining: raises
    CoordinatorConnectError when nothing listens there within
    timeout_s. Rank 0 skips it (it serves the store)."""
    if process_id == 0:
        return
    import socket

    address = f"{_url_host(host)}:{port}"
    deadline = time.monotonic() + timeout_s
    last_err: BaseException = TimeoutError(
        f"no listener within {timeout_s:.0f}s")
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(
                    (host, int(port)),
                    timeout=max(0.5, min(5.0, deadline - time.monotonic()))):
                return
        except OSError as e:
            last_err = e
            time.sleep(min(0.5, max(0.0, deadline - time.monotonic())))
    raise CoordinatorConnectError(address, process_id, num_processes,
                                  timeout_s, last_err)


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
    rdv = _env_rendezvous()
    return None if rdv is None else (f"tcp://{_url_host(rdv[0])}:{rdv[1]}",
                                      rdv[2], rdv[3])


def _env_rendezvous() -> tuple[str, str, int, int] | None:
    """(host, port, rank, world_size) of the job the environment names."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if addr and port and rank is not None and world is not None:
        return addr, port, int(rank), int(world)
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
    return host, port, pid, int(num)


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


def initialize_from_env(backend: str | None = "nccl", device=None) -> bool:
    """init_process_group from the environment (see the module
    docstring). True when this process is (now) part of a group, False
    when no job is configured (dist.get_world_size() then says how many
    processes joined).

    `backend=None` places the ranks by `choose_placement` from `device`
    ('cuda' or 'cpu') and each host's view (see the module docstring):
    this rank's card becomes the current one, the backend is the
    rule's, and job_placement() says which. A rank other than 0 waits for the
    coordinator at most JAX_COORDINATOR_TIMEOUT_S seconds, then raises
    CoordinatorConnectError."""
    global _PLACED
    if dist.is_initialized():
        return True
    rdv = _env_rendezvous()
    if rdv is None:
        return False
    host, port, rank, world = rdv
    address = f"{_url_host(host)}:{port}"
    timeout_s = coordinator_timeout_s()
    timeout = datetime.timedelta(seconds=max(timeout_s, 1.0))
    probe_coordinator(host, port, rank, world, timeout_s)
    join = {"init_method": f"tcp://{address}"}
    if backend is None and torch.device(device or "cuda").type == "cpu":
        backend, device = "gloo", torch.device("cpu")
    elif backend is None:
        _need_cuda()
        hosts = torchrun_hosts(world)
        if hosts is None:
            try:
                store = dist.TCPStore(host, int(port), world, rank == 0,
                                      timeout=timeout)
                hosts = exchange_hosts(store, rank, world)
            except (RuntimeError, OSError) as e:
                raise CoordinatorConnectError(address, rank, world,
                                              timeout_s, e) from e
            join = {"store": store}
        backend, device = choose_placement(hosts, rank, "cuda")
        torch.cuda.set_device(device)
    log.info("joining %s as rank %d of %d (%s on %s)", address, rank, world,
             backend, device)
    try:
        dist.init_process_group(
            backend, rank=rank, world_size=world, timeout=timeout, **join,
            **device_kwargs(backend, device))
    except (RuntimeError, OSError) as e:
        if isinstance(e, RuntimeError) and "CUDA" in str(e):
            raise
        raise CoordinatorConnectError(address, rank, world, timeout_s,
                                      e) from e
    _PLACED = (backend, torch.device(device) if device is not None
               else group_device())
    return True


def job_placement() -> tuple[str, torch.device]:
    """(backend, this rank's device) of the job initialize_from_env
    joined."""
    if _PLACED is None:
        raise RuntimeError("no job joined: call initialize_from_env first")
    return _PLACED


def torchrun_hosts(world: int) -> list[tuple[str, int]] | None:
    """Each rank's (host, cards) under torchrun, from its
    LOCAL_WORLD_SIZE: ranks numbered host by host, every host running
    as many ranks and showing as many cards as this one (torchrun's
    --nproc-per-node); None outside torchrun."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if not local or not local.isdigit() or int(local) < 1:
        return None
    local, cards = int(local), torch.cuda.device_count()
    return [(str(r // local), cards) for r in range(world)]


def exchange_hosts(store, rank: int, world: int) -> list[tuple[str, int]]:
    """Each rank's (host name, cards it shows), posted by every rank to
    the job's store and read back in rank order."""
    import socket

    store.set(f"placement/{rank}",
              f"{socket.gethostname()}\t{torch.cuda.device_count()}")
    keys = [f"placement/{r}" for r in range(world)]
    store.wait(keys)
    out = []
    for key in keys:
        name, cards = store.get(key).decode().rsplit("\t", 1)
        out.append((name, int(cards)))
    return out


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


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of a tensor-parallel group: the process group,
    this rank, the group's size, its backend and this rank's device."""
    group: object
    rank: int
    size: int
    backend: str
    device: torch.device

    def global_rank(self, group_rank: int) -> int:
        return global_rank(self.group, group_rank)


def choose_placement(hosts: list[tuple[str, int]], rank: int,
                     device="cuda") -> tuple[str, torch.device]:
    """(backend, device) of `rank` in a job whose rank r runs on host
    hosts[r][0], which shows hosts[r][1] cards: NCCL with each rank on
    cuda:<its index among its host's ranks> where every host shows at
    least as many cards as it runs ranks; where one shows fewer, gloo
    with every rank on cuda:0 for a job on one host, and a RuntimeError
    for a job across hosts (its ranks stacked on one card would stage
    every collective through the host); gloo on the CPU for device
    'cpu'. Every rank reaches the same answer from the same list."""
    if not hosts:
        raise ValueError("a group needs at least one rank, got 0")
    if torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu")
    ranks: dict[str, list[int]] = {}
    for r, (name, _) in enumerate(hosts):
        ranks.setdefault(name, []).append(r)
    short = [(name, len(rs), hosts[rs[0]][1]) for name, rs in ranks.items()
             if len(rs) > hosts[rs[0]][1]]
    if not short:
        return "nccl", torch.device(
            "cuda", ranks[hosts[rank][0]].index(rank))
    if len(ranks) == 1:
        return "gloo", torch.device("cuda", 0)
    name, n, cards = short[0]
    raise RuntimeError(
        f"host {name!r} runs {n} ranks of a {len(hosts)}-rank job across "
        f"{len(ranks)} hosts but shows {cards} card(s): launch at most one "
        f"rank per card there (torchrun --nproc-per-node {cards})")


def placement(n: int, device="cuda") -> tuple[str, list[torch.device]]:
    """(backend, each rank's device) of an `n`-rank group on this host
    (choose_placement): NCCL with rank r on cuda:r where the process
    sees at least n cards, gloo with every rank on cuda:0 where it sees
    fewer, gloo on the CPU for device 'cpu'. A CUDA placement without
    CUDA raises."""
    if n < 1:
        raise ValueError(f"a group needs at least one rank, got {n}")
    if torch.device(device).type != "cpu":
        _need_cuda()
    hosts = [("", torch.cuda.device_count())] * n
    picks = [choose_placement(hosts, r, device) for r in range(n)]
    return picks[0][0], [d for _, d in picks]


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("a group of ranks on the card needs CUDA, and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to run on the CPU")


def tp_placement(tp: int, device="cuda") -> tuple[str, list[torch.device]]:
    """`placement` of a `tp`-rank tensor-parallel group."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    return placement(tp, device)


def init_tp_group(rank: int, tp: int, store, backend: str, device,
                  timeout_s: float) -> TPGroup:
    """Join the `tp`-rank group as `rank`, over `store` (a TCPStore
    rank 0 serves), on this rank's `device` (tp_placement). The
    collectives time out after timeout_s seconds."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    log.info("tp rank %d of %d: %s on %s", rank, tp, backend, device)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=timeout_s),
        **(device_kwargs(backend, device) if backend == "nccl" else {}))
    return TPGroup(dist.group.WORLD, rank, tp, backend, device)
