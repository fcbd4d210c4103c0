"""Run one function in a few rank processes on this host: the job's
world as cli/train.py forms it (torchrun's MASTER_ADDR, MASTER_PORT,
RANK and WORLD_SIZE, which parallel/distributed.initialize_from_env
reads), for the tests and the smoke's multi-rank checks.

    results = run_ranks("pkg.module:function", world=2,
                        kwargs={"steps": 3})

starts `world` processes of

    python -m container_engine_accelerators_tpu_torch.parallel.launch \
        pkg.module:function RANK WORLD PORT KWARGS OUT

each of which calls function(**kwargs) (the function joins the group
itself, through initialize_from_env) and pickles its result to OUT;
run_ranks returns them by rank. A rank that fails or outlives `timeout`
fails the run: every rank is then killed and the error carries each
failed rank's stderr tail.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world: int, kwargs: dict | None = None, *,
              timeout: float = 300.0, env: dict | None = None,
              cwd: str | None = None, threads: int = 1,
              echo: bool = False) -> list:
    """`target(**kwargs)` in `world` rank processes; their results by
    rank. `threads` caps each rank's torch threads (OMP_NUM_THREADS).
    With `echo` the ranks write to this process's stderr as they run
    (a failure then names the ranks only)."""
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        args_path = os.path.join(d, "kwargs.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(kwargs or {}, f)
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(world)]
        errs = [None if echo else open(os.path.join(d, f"rank{r}.err"),
                                       "w+") for r in range(world)]
        base = dict(os.environ, **(env or {}))
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, target, str(r), str(world),
             str(port), args_path, outs[r]], cwd=cwd,
            stdout=subprocess.DEVNULL, stderr=errs[r],
            env=dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     RANK=str(r), WORLD_SIZE=str(world),
                     OMP_NUM_THREADS=str(threads)))
            for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        failed = []
        for r, (p, err) in enumerate(zip(procs, errs)):
            tail = "(its stderr above)"
            if err is not None:
                err.seek(0)
                tail = err.read()[-3000:]
                err.close()
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{tail}")
        if failed:
            raise RuntimeError(f"{target} over {world} ranks failed:\n"
                               + "\n".join(failed))
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def _main(argv: list[str]) -> int:
    target, _rank, _world, _port, args_path, out_path = argv
    module, _, name = target.partition(":")
    with open(args_path, "rb") as f:
        kwargs = pickle.load(f)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    result = getattr(importlib.import_module(module), name)(**kwargs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
