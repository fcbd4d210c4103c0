"""fleetmon: the fleet telemetry plane CLI, the port's copy of the JAX
package's cli/fleetmon.py (the same flags, ready line and families).

Scrapes N serve replicas' /metrics + /debugz?state=1 endpoints on its
own cadence (metrics/fleet.py FleetScraper — never on any engine tick
path), keeps the versioned FleetState table, and re-exports the fleet
rollup on its own port:

    python -m container_engine_accelerators_tpu_torch.cli.fleetmon \
        --endpoints http://127.0.0.1:9001,http://127.0.0.1:9002 \
        --replica-ids rA,rB --port 9100 --doctor

/metrics then carries fleet_replicas{state=up|stale|down}, aggregate
KV-headroom / queue-depth / prefix-hit gauges and per-replica labeled
mirrors; /debugz?state=1 serves the replica table machine-readably
(the same contract the replicas serve fleetmon). With --doctor the
full detector registry runs live in this process — the engine-local
detectors are quiet here (no serve/* events on fleetmon's bus) and
the fleet detectors (replica_down, fleet_imbalance, fleet_slo_burn)
emit the standard incident bundles chaos asserts on.

On startup one machine-readable line lands on stdout:

    {"kind": "fleetmon", "port": <bound>, "replicas": [...], ...}

so launchers (chip_smoke.py's doctor phase, tests) discover the
ephemeral port. Imports no torch.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.metrics.fleet import (
    FleetExporter,
    FleetScraper,
)

log = logging.getLogger(__name__)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--endpoints", required=True,
                   help="comma-separated replica metrics base URLs "
                        "(each serving /metrics and /debugz?state=1)")
    p.add_argument("--replica-ids", default=None,
                   help="comma-separated replica ids matching "
                        "--endpoints order (default: r0,r1,...); keep "
                        "these equal to each replica's --replica-id so "
                        "fleet verdicts and merged timelines name the "
                        "same replica")
    p.add_argument("--port", type=int, default=0,
                   help="fleet exporter port (0 = ephemeral, printed "
                        "on the ready line)")
    p.add_argument("--host", default="",
                   help="bind host for the fleet exporter")
    p.add_argument("--interval", type=float, default=1.0,
                   help="scrape cadence in seconds")
    p.add_argument("--down-after", type=float, default=5.0,
                   help="seconds without a successful scrape before a "
                        "replica degrades stale -> down")
    p.add_argument("--timeout", type=float, default=2.0,
                   help="per-request scrape timeout in seconds")
    p.add_argument("--doctor", action="store_true",
                   help="run the streaming doctor over the fleet/* "
                        "event stream: replica_down / fleet_imbalance "
                        "/ fleet_slo_burn incidents, doctor/<class> "
                        "instants, /debugz?doctor=1 verdicts")
    p.add_argument("--doctor-dir", default=None,
                   help="directory for doctor incident bundles "
                        "(default: TPU_DOCTOR_DIR env, else next to "
                        "the trace dump, else the cwd)")
    p.add_argument("--doctor-interval", type=float, default=5.0,
                   help="doctor evaluation cadence in seconds (chaos "
                        "runs shrink this to catch sub-minute faults)")
    p.add_argument("--trace-dump", default=None,
                   help="enable the flight recorder and dump the "
                        "fleet/* event ring as Chrome-trace JSON here "
                        "on exit and SIGUSR2 — the fleetmon track of "
                        "the merged multi-replica timeline")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.trace_dump:
        events.enable(dump_path=args.trace_dump, signals=True,
                      process_name="fleetmon")
    else:
        events.configure_from_env(process_name="fleetmon")

    endpoints = [e.strip() for e in args.endpoints.split(",")
                 if e.strip()]
    if not endpoints:
        make_parser().error("--endpoints is empty")
    replica_ids = None
    if args.replica_ids:
        replica_ids = [r.strip() for r in args.replica_ids.split(",")
                       if r.strip()]

    scraper = FleetScraper(endpoints, replica_ids=replica_ids,
                           timeout_s=args.timeout,
                           down_after_s=args.down_after)
    exporter = FleetExporter(scraper, port=args.port, host=args.host,
                             interval=args.interval)
    exporter.start_background()

    if args.doctor:
        from container_engine_accelerators_tpu_torch.metrics import doctor
        if not events.enabled():
            # The detectors read the fleet/* stream off the flight
            # recorder; --doctor without a dump path still needs it.
            events.enable(process_name="fleetmon")
        cfg = doctor.DoctorConfig(
            poll_interval_s=args.doctor_interval)
        doc = doctor.Doctor(
            config=cfg, registry=exporter.registry,
            out_dir=args.doctor_dir if args.doctor_dir else "auto")
        doc.start()
        doctor.set_active(doc)

    ready = {"kind": "fleetmon", "port": exporter.bound_port,
             "replicas": [rid for rid, _ in scraper.targets],
             "endpoints": [url for _, url in scraper.targets],
             "interval_s": args.interval,
             "down_after_s": args.down_after}
    print(json.dumps(ready), flush=True)
    log.info("fleetmon scraping %d replicas every %.2fs; fleet "
             "metrics on :%d/metrics", len(scraper.targets),
             args.interval, exporter.bound_port)

    # Signal-friendly idle loop on the MAIN thread: SIGUSR2 (on-demand
    # trace dump, installed by events.enable above) and SIGTERM/SIGINT
    # interrupt the wait; a graceful return runs the atexit dump.
    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    while not stop.wait(0.5):
        pass
    exporter.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
