"""inject-fault: append error records to the health checker's JSONL
feed, the port's counterpart of the JAX package's cli/inject_fault.py
(its default kind, `health`, with the same flags).

Each record {"chip": N, "class": "...", "message": "..."} flows through
LogFileErrorSource into TPUHealthChecker: a critical class turns the
card's devices Unhealthy and writes the node condition and a Warning
Event. The feed carries the classes that cannot be provoked safely on a
card (an uncorrectable ECC error, a lost bus):

  python -m container_engine_accelerators_tpu_torch.cli.inject_fault \\
      --chip 0 --error-class HBM_ECC_UNCORRECTABLE --error-log PATH

The doctor's kinds (hang, worker-kill, ...) wait for the doctor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from container_engine_accelerators_tpu_torch.deviceplugin.config import (
    KNOWN_ERROR_CLASSES,
)
from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (
    DEFAULT_ERROR_LOG,
)

FAULT_KINDS = ("health",)


def _append_jsonl(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # One newline-terminated line per write: tailers consume only
    # complete lines, so a reader never parses a torn record.
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kind", default="health", choices=FAULT_KINDS,
                   help="health = JSONL error record for the health "
                        "checker")
    p.add_argument("--chip", type=int, default=0,
                   help="-1 targets the whole host")
    p.add_argument("--error-class", default="HBM_ECC_UNCORRECTABLE",
                   choices=KNOWN_ERROR_CLASSES)
    p.add_argument("--message", default="injected by inject_fault")
    p.add_argument("--error-log", default=DEFAULT_ERROR_LOG)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--interval", type=float, default=1.0)
    args = p.parse_args(argv)

    for i in range(args.repeat):
        _append_jsonl(args.error_log, {
            "chip": args.chip,
            "class": args.error_class,
            "message": args.message})
        print(f"injected {args.error_class} for chip {args.chip} "
              f"({i + 1}/{args.repeat})")
        if i + 1 < args.repeat:
            time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
