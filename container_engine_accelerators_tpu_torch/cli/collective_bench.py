"""collective-bench: the collective bandwidth harness, the JAX package's
`cli/collective_bench.py` over torch.distributed (its flags mirror
nccl-tests' `all_gather_perf -b 1M -e 512M -f 2 -w 5 --iters 100`).

One process is one rank on one card. Alone, it probes a one-rank group
(n = 1: only ppermute moves bytes, a copy through the group; the other
four read busBW 0). As one rank of a job, set --coordinator,
--num-processes and --process-id, or launch it under torchrun
(MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE) or with the JAX package's
JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID.

--backend names the torch.distributed backend: nccl (the default) runs
on the card and raises without one; gloo runs on the CPU.

  python -m container_engine_accelerators_tpu_torch.cli.collective_bench \
      --collective all -b 1M -e 512M -f 2 -w 5 --iters 20 --json
"""

from __future__ import annotations

import argparse
import json
import re
import sys


def parse_size(text: str) -> int:
    m = re.fullmatch(r"(\d+)([kKmMgG]?)", text)
    if not m:
        raise argparse.ArgumentTypeError(f"bad size {text!r}")
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}
    return int(m.group(1)) * mult[m.group(2).lower()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--collective", default="all_reduce",
                   help="all_reduce|all_gather|reduce_scatter|all_to_all|"
                        "ppermute|all (comma list allowed)")
    p.add_argument("-b", "--begin", type=parse_size, default=parse_size("1M"))
    p.add_argument("-e", "--end", type=parse_size, default=parse_size("512M"))
    p.add_argument("-f", "--factor", type=int, default=2)
    p.add_argument("-w", "--warmup", type=int, default=5)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--axis", default="ici",
                   help="the axis to label the group with: ici | dcn "
                        "(dcn only where the job has several ranks)")
    p.add_argument("--backend", default="nccl",
                   help="torch.distributed backend: nccl (the card) or "
                        "gloo (the CPU)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per size instead of the table")
    # A job of several ranks.
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.ops import collectives
    from container_engine_accelerators_tpu_torch.parallel import distributed

    if args.coordinator:
        host, port = distributed.split_host_port(args.coordinator)
        dist.init_process_group(
            args.backend, init_method=f"tcp://{host}:{port}",
            world_size=args.num_processes, rank=args.process_id,
            **distributed.device_kwargs(args.backend, None))
        group = dist.group.WORLD
    else:
        group = distributed.default_group(args.backend)
    try:
        world = dist.get_world_size(group)
        axis = "dcn" if args.axis == "dcn" and world > 1 else "ici"
        mesh = {"dcn": world, "ici": 1} if axis == "dcn" \
            else {"dcn": 1, "ici": world}
        names = list(collectives.COLLECTIVES) if args.collective == "all" \
            else [c.strip() for c in args.collective.split(",")]
        all_results = []
        for name in names:
            results = collectives.sweep(
                group, axis, name, begin_bytes=args.begin,
                end_bytes=args.end, factor=args.factor,
                warmup=args.warmup, iters=args.iters)
            all_results.extend(results)
            if args.json:
                for r in results:
                    print(json.dumps({
                        "collective": r.collective,
                        "size_bytes": r.size_bytes,
                        "time_us": round(r.time_us, 1),
                        "alg_bw_gbps": round(r.alg_bw_gbps, 3),
                        "bus_bw_gbps": round(r.bus_bw_gbps, 3),
                        "axis": axis, "devices": world}), flush=True)
        if not args.json:
            print(f"# devices={world} axis={axis} mesh={mesh}")
            print(collectives.report(all_results))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
