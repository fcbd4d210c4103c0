"""Capture the real-failure corpus on the card.

Runs each provocation and a benign control (a healthy bf16 matmul) as a
subprocess and writes its verbatim stderr to `<out>/<name>.log`: the
corpus the health checker's default scrape rules are held against
(tests/test_torch_health.py). The counterpart of the JAX package's
demo/tpu-error/real-fault/capture.sh.

  python -m container_engine_accelerators_tpu_torch.demo.real_fault.capture [--out DIR]

Prints one JSON line: each run's exit code, what it should have been, and
its stderr's length. Exits non-zero when a run did not end as expected.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
LOG_DIR = HERE / "logs"
PACKAGE = "container_engine_accelerators_tpu_torch.demo.real_fault"
BENIGN = """\
import torch
a = torch.ones((512, 512), dtype=torch.bfloat16, device="cuda")
print(float((a @ a).sum()))
"""
# name -> (python arguments, whether it must fail)
RUNS = {
    "smem_oom": (["-m", f"{PACKAGE}.provoke_smem_oom"], True),
    "hbm_oom": (["-m", f"{PACKAGE}.provoke_hbm_oom"], True),
    "benign_success": (["-c", BENIGN], False),
}


def provoke(name: str, timeout: float = 600) -> tuple[int, str]:
    """Run one of RUNS in a process of its own: (exit code, stderr)."""
    args, _ = RUNS[name]
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(LOG_DIR),
                   help="directory for the <name>.log files")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report, ok = {}, True
    for name, (_, must_fail) in RUNS.items():
        rc, err = provoke(name)
        (out / f"{name}.log").write_text(err)
        ok &= (rc != 0) == must_fail
        report[name] = {"rc": rc, "must_fail": must_fail,
                        "stderr_bytes": len(err.encode())}
    print(json.dumps({"capture": report, "out": str(out)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
