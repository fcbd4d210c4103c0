"""trace — flight-recorder timeline tooling (metrics/events.py), the
port's copy of the JAX package's.

  trace dump   Trigger or convert EventBus dumps.
                 --pid P          send SIGUSR2 to a live process that
                                  was started with a trace dump path
                                  (--trace-dump / TPU_TRACE_DUMP); it
                                  writes its ring to that path.
                 DUMP.json -o OUT rebase one or more raw dumps to a
                                  single epoch-aligned Chrome trace
                                  (same machinery as merge).

  trace merge  Merge per-process EventBus dumps (of either package),
               the train recorder's JSONL step logs (--train-jsonl,
               `train --metrics-log`) and stamped SSE event logs
               (--sse-log) into ONE clock-aligned Chrome-trace JSON:

                 trace merge serve-trace.json other-trace.json \\
                     --train-jsonl steps.jsonl --sse-log sse.jsonl \\
                     -o merged.json

               Open the output at ui.perfetto.dev (or chrome://tracing).

  trace oom    Pretty-print an OOM forensics bundle
               (metrics/introspection.py writes one next to the trace
               dump when a serving engine dies out of device memory):
               the error, per-device memory, the largest live blocks
               and the kernel library's build record.

  trace doctor Replay a merged timeline (or one raw dump, of either
               package) through the doctor's detector registry
               (metrics/doctor.py): the incidents a live `--doctor`
               would have raised, one line each (--json: one JSON
               incident per line); --fail-on-incident exits 1 if any
               fired, --window shrinks the detection windows for short
               traces, --out-dir also writes each incident bundle.

                 trace doctor merged.json --window 10 --fail-on-incident

  python -m container_engine_accelerators_tpu_torch.cli.trace merge \\
      /tmp/traces/trace-1234.json -o merged.json

Exit code 0 on success; 1 when `doctor --fail-on-incident` found an
incident; 2 on bad usage or an unreadable input.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys

log = logging.getLogger("tpu-trace")


def _write(trace: dict, out_path: str) -> None:
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    # tmp + os.replace: Perfetto/chrome://tracing may be pointed at the
    # output while a re-merge runs; never show it a torn file.
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, out_path)
    n = sum(1 for e in trace.get("traceEvents", ())
            if e.get("ph") != "M")
    print(f"wrote {out_path}: {n} events from "
          f"{len((trace.get('otherData') or {}).get('sources', []))} "
          f"source(s)")


def cmd_dump(args) -> int:
    from container_engine_accelerators_tpu_torch.metrics.events import (
        merge_traces,
    )

    if args.pid is not None:
        os.kill(args.pid, signal.SIGUSR2)
        print(f"sent SIGUSR2 to pid {args.pid}; the process writes its "
              "ring to its configured --trace-dump / TPU_TRACE_DUMP "
              "path")
        return 0
    if not args.inputs:
        print("trace dump: need --pid or at least one dump file",
              file=sys.stderr)
        return 2
    out = args.out or (os.path.splitext(args.inputs[0])[0]
                       + ".chrome.json")
    _write(merge_traces(args.inputs), out)
    return 0


def cmd_merge(args) -> int:
    from container_engine_accelerators_tpu_torch.metrics.events import (
        merge_traces,
    )

    if not (args.inputs or args.train_jsonl or args.sse_log):
        print("trace merge: nothing to merge", file=sys.stderr)
        return 2
    _write(merge_traces(args.inputs, args.train_jsonl, args.sse_log),
           args.out)
    return 0


def _gb(n) -> str:
    return f"{n / 1e9:.2f} GB" if isinstance(n, (int, float)) else "?"


def cmd_oom(args) -> int:
    try:
        with open(args.bundle) as f:
            b = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"trace oom: cannot read {args.bundle}: {e}",
              file=sys.stderr)
        return 2
    if b.get("kind") != "tpu_oom_forensics":
        print(f"trace oom: {args.bundle} is not an OOM forensics "
              "bundle", file=sys.stderr)
        return 2

    err = b.get("error") or {}
    print(f"OOM forensics bundle (pid {b.get('pid')}, "
          f"context {b.get('context')!r})")
    if err:
        print(f"  error: {err.get('type')}: "
              f"{(err.get('message') or '')[:200]}")

    for row in b.get("device_memory_stats", []):
        if not row.get("stats_available"):
            print(f"  {row.get('device')}: memory_stats unavailable "
                  f"({row.get('kind')})")
            continue
        print(f"  {row.get('device')}: in_use {_gb(row.get('bytes_in_use'))}"
              f"  peak {_gb(row.get('peak_bytes_in_use'))}"
              f"  limit {_gb(row.get('bytes_limit'))}")

    census = b.get("live_array_census") or {}
    rows = census.get("rows", [])
    print(f"  live arrays: {census.get('n_arrays', 0)} totalling "
          f"{_gb(census.get('total_bytes', 0))}; "
          f"top {min(args.top, len(rows))}:")
    for row in rows[:args.top]:
        print(f"    {_gb(row['nbytes']):>10s}  {row.get('device')} "
              f"stream {row.get('stream')}  {row.get('address')}")

    build = b.get("kernel_build") or {}
    if build:
        print(f"  kernel library: {build.get('library')} (compiled "
              f"here: {build.get('compiled')}, {build.get('seconds')} s)")
    n_ev = len((b.get("recent_events") or {}).get("events", []))
    print(f"  event ring: {n_ev} recent events in the bundle")
    return 0


def cmd_doctor(args) -> int:
    from container_engine_accelerators_tpu_torch.metrics import doctor

    try:
        with open(args.trace) as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"trace doctor: cannot read {args.trace}: {e}",
              file=sys.stderr)
        return 2
    cfg = doctor.DoctorConfig()
    if args.window is not None:
        cfg.fast_window_s = args.window
        cfg.slow_window_s = args.window * 5
        cfg.hang_after_s = min(cfg.hang_after_s, args.window)
        cfg.clear_after_s = min(cfg.clear_after_s, args.window)
    if args.interval is not None:
        cfg.poll_interval_s = args.interval
    incidents = doctor.replay(trace, config=cfg, out_dir=args.out_dir)
    if args.json:
        for inc in incidents:
            print(json.dumps(inc))
    else:
        n_ev = sum(1 for e in trace.get("traceEvents", ())
                   if e.get("ph") != "M")
        print(f"trace doctor: {len(incidents)} incident(s) over "
              f"{n_ev} events")
        for inc in incidents:
            print(f"  [{inc['class']}] {inc['subject']} "
                  f"(confidence {inc['confidence']:.2f}): "
                  f"{inc['summary']}")
            if inc.get("bundle_path"):
                print(f"      bundle: {inc['bundle_path']}")
    if args.fail_on_incident and incidents:
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)  # noqa: E501
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump", help="signal a live process to dump, or "
                                    "convert raw dumps to epoch time")
    d.add_argument("--pid", type=int, default=None,
                   help="send SIGUSR2 to this pid (it must have a dump "
                        "path configured)")
    d.add_argument("inputs", nargs="*",
                   help="raw EventBus dump file(s) to rebase/convert")
    d.add_argument("-o", "--out", default=None,
                   help="output path (default: <first input>.chrome.json)")
    d.set_defaults(fn=cmd_dump)

    m = sub.add_parser("merge", help="merge dumps + step logs + SSE "
                                     "logs into one timeline")
    m.add_argument("inputs", nargs="*",
                   help="EventBus dump files (one per process)")
    m.add_argument("--train-jsonl", action="append", default=[],
                   help="train-recorder JSONL step log "
                        "(`train --metrics-log`; repeatable)")
    m.add_argument("--sse-log", action="append", default=[],
                   help="saved SSE event log with epoch `t` stamps "
                        "(repeatable)")
    m.add_argument("-o", "--out", required=True)
    m.set_defaults(fn=cmd_merge)

    o = sub.add_parser("oom", help="pretty-print an OOM forensics "
                                   "bundle (introspection.py)")
    o.add_argument("bundle", help="bundle JSON written on "
                                  "RESOURCE_EXHAUSTED")
    o.add_argument("--top", type=int, default=10,
                   help="live-array census rows to show")
    o.set_defaults(fn=cmd_oom)

    dr = sub.add_parser("doctor", help="replay a merged timeline "
                                       "through the tpu-doctor "
                                       "detector registry")
    dr.add_argument("trace", help="merged timeline (trace merge) or "
                                  "raw EventBus dump JSON")
    dr.add_argument("--window", type=float, default=None,
                    help="fast detection window seconds (slow = 5x; "
                         "also caps hang/clear thresholds) — shrink "
                         "for short traces")
    dr.add_argument("--interval", type=float, default=None,
                    help="replay clock step seconds (default: the "
                         "doctor poll interval)")
    dr.add_argument("--json", action="store_true",
                    help="print one JSON incident per line")
    dr.add_argument("--out-dir", default=None,
                    help="also write each verdict as an incident "
                         "bundle under this directory")
    dr.add_argument("--fail-on-incident", action="store_true",
                    help="exit 1 if any incident fires (CI gate)")
    dr.set_defaults(fn=cmd_doctor)

    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
