"""inject-fault — chaos injection for the health pipeline and the
doctor, the port's copy of the JAX package's cli/inject_fault.py (the
same kinds and flags, and byte for byte the same JSONL records).

The default kind (`health`) appends error records to the health
checker's JSONL feed: {"chip": N, "class": "...", "message": "..."}
flows through LogFileErrorSource into TPUHealthChecker, and a critical
class turns the card's devices Unhealthy and writes the node condition
and a Warning Event. The feed carries the classes that cannot be
provoked safely on a card (an uncorrectable ECC error, a lost bus):

  python -m container_engine_accelerators_tpu_torch.cli.inject_fault \
      --chip 0 --error-class HBM_ECC_UNCORRECTABLE --error-log PATH

The doctor kinds append fault COMMANDS to a JSONL fault log that a live
process started with `serve --fault-listen PATH` or `train
--fault-listen PATH` tails (metrics/doctor.py FaultListener); each trips
a real failure mode in that process, so the doctor's detectors are
exercised end to end:

  --kind hang            worker-thread sleep with slots occupied
                         (--seconds)
  --kind worker-kill     the engine worker thread DIES at its next
                         loop top with in-flight work abandoned (the
                         `serve --supervise` recovery path's trigger)
  --kind prefill-kill    ONE prefill-pool worker DIES at its next
                         loop top (`serve --prefill-workers`); decode
                         keeps ticking and the supervisor replaces
                         the worker without failing any request
  --kind recompile-storm the JAX package's real recompiles of a
                         watched jit (--count); the port compiles
                         nothing at run time, so its listener logs the
                         command and trips nothing
  --kind hbm-climb       fabricated hbm/<device> exhaustion climb
                         (--seconds, --device)
  --kind queue-collapse  fabricated queue-depth growth, zero admits
                         (--seconds, --depth)
  --kind data-stall      the target's NEXT data-loader batch fetch
                         sleeps --seconds (training/dataset.py stall
                         hook; `train --fault-listen`)
  --kind straggler       EVERY batch fetch sleeps --delay for the
                         next --seconds: the target becomes the slow
                         rank the watchdog/doctor must name
  --kind health-tail     the target runs a real TPUHealthChecker
                         tailing --path for --seconds, so `--kind
                         health --error-log <path>` records flow
                         through the production health pipeline in
                         the target process
  --kind fabric-slow     throttle the fabric health monitor's probes
                         (metrics/fabric_health.inject_slow): probes
                         over --axis whose group holds --rank sleep
                         inside their timed window and read --factor
                         slower for --seconds

  python -m container_engine_accelerators_tpu_torch.cli.inject_fault \
      --kind hang --seconds 5 --fault-log /tmp/faults.jsonl
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

FAULT_KINDS = ("health", "hang", "worker-kill", "prefill-kill",
               "recompile-storm", "hbm-climb", "queue-collapse",
               "data-stall", "straggler", "health-tail",
               "fabric-slow")


def _append_jsonl(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # One newline-terminated line per write: tailers (health checker,
    # fault listener) consume only complete lines, so a reader never
    # parses a torn record.
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _doctor_record(args) -> dict:
    kind = args.kind.replace("-", "_")
    rec: dict = {"kind": kind}
    if kind in ("hang", "data_stall"):
        rec["seconds"] = args.seconds
    elif kind == "recompile_storm":
        rec["n"] = args.count
    elif kind == "hbm_climb":
        rec.update(device=args.device, seconds=args.seconds,
                   start_frac=args.start_frac, end_frac=args.end_frac)
    elif kind == "queue_collapse":
        rec.update(depth=args.depth, seconds=args.seconds)
    elif kind == "straggler":
        rec.update(delay_s=args.delay, seconds=args.seconds)
    elif kind == "health_tail":
        rec.update(path=args.path, seconds=args.seconds)
    elif kind == "fabric_slow":
        rec.update(axis=args.axis, rank=args.rank,
                   factor=args.factor, seconds=args.seconds)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", default="health", choices=FAULT_KINDS,
                   help="health = JSONL error record for the health "
                        "checker (default); the rest are doctor/chaos "
                        "fault commands for a --fault-listen process")
    # health kind
    p.add_argument("--chip", type=int, default=0,
                   help="-1 targets the whole host")
    p.add_argument("--error-class", default="HBM_ECC_UNCORRECTABLE",
                   choices=KNOWN_ERROR_CLASSES)
    p.add_argument("--message", default="injected by inject_fault")
    p.add_argument("--error-log", default=DEFAULT_ERROR_LOG)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--interval", type=float, default=1.0)
    # doctor kinds
    p.add_argument("--fault-log", default=None,
                   help="fault-command JSONL the target process tails "
                        "(its serve --fault-listen path); required "
                        "for non-health kinds")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="hang sleep / fabricated-climb duration")
    p.add_argument("--count", type=int, default=4,
                   help="recompile-storm: steady-state recompiles to "
                        "force")
    p.add_argument("--device", default="injected:0",
                   help="hbm-climb: device label for the fabricated "
                        "hbm/<device> track")
    p.add_argument("--start-frac", type=float, default=0.5)
    p.add_argument("--end-frac", type=float, default=0.97)
    p.add_argument("--depth", type=int, default=8,
                   help="queue-collapse: fabricated final queue depth")
    p.add_argument("--delay", type=float, default=1.0,
                   help="straggler: per-batch-fetch sleep seconds "
                        "(applied for --seconds)")
    p.add_argument("--path", default=None,
                   help="health-tail: the error JSONL the target "
                        "should tail with a real TPUHealthChecker "
                        "(append records to it with --kind health "
                        "--error-log <path>)")
    p.add_argument("--axis", default="dp",
                   help="fabric-slow: mesh axis whose probe path to "
                        "throttle")
    p.add_argument("--rank", type=int, default=0,
                   help="fabric-slow: the rank along --axis that "
                        "reads slow (what localization should name)")
    p.add_argument("--factor", type=float, default=8.0,
                   help="fabric-slow: slowdown factor on measured "
                        "probe time")
    args = p.parse_args(argv)

    if args.kind != "health":
        if not args.fault_log:
            p.error(f"--kind {args.kind} requires --fault-log (the "
                    "target's serve/train --fault-listen path)")
        if args.kind == "health-tail" and not args.path:
            p.error("--kind health-tail requires --path (the error "
                    "JSONL the target should tail)")
        rec = _doctor_record(args)
        _append_jsonl(args.fault_log, rec)
        print(f"injected {args.kind} fault command -> {args.fault_log}: "
              f"{json.dumps(rec)}")
        return 0

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
