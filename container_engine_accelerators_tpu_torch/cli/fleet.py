"""fleet: launch N supervised serve replicas on ephemeral ports, the
port's copy of the JAX package's cli/fleet.py.

The smallest thing that makes the fleet telemetry plane demoable on one
machine (on one card, the replicas share it by time-slicing):

    python -m container_engine_accelerators_tpu_torch.cli.fleet \
        --replicas 2 -- --engine paged --trace-dump /tmp/fleet

spawns N `cli.serve --tiny --supervise` children (the port's serve:
with `-- --checkpoint DIR` a checkpoint instead of --tiny), each with
its own
serve port + metrics port and a stable `--replica-id r<i>`, waits for
every /healthz, then prints one machine-readable line:

    {"kind": "fleet", "replicas": [
        {"id": "r0", "url": "http://127.0.0.1:PORT",
         "metrics_url": "http://127.0.0.1:MPORT", "pid": ...}, ...]}

Point fleetmon at the metrics_url list and loadgen --targets at the
url list. Everything after `--` is forwarded to each serve child
verbatim (so --engine/--trace-dump/--checkpoint all work; per-child
paths get the replica id suffixed to avoid collisions). The launcher
stays in the foreground relaying SIGINT/SIGTERM to the children; it
exits non-zero if any replica dies while it is supervising, and stops
the others then, unless `--keep-survivors` is given: a dead replica is
then logged and the rest keep serving (the fleet's replica_down case)
until the launcher is signalled, when it exits 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import socket
import subprocess
import sys
import time
import urllib.request

log = logging.getLogger(__name__)

SERVE_MOD = "container_engine_accelerators_tpu_torch.cli.serve"


def _free_port() -> int:
    """Bind-release an ephemeral port; the tiny reuse window is fine
    for a local launcher."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_healthy(url: str, deadline: float) -> bool:
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url + "/healthz",
                                        timeout=1.0) as r:
                if r.status == 200:
                    return True
        except Exception:
            time.sleep(0.1)
    return False


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        usage="%(prog)s [options] [-- serve-args...]")
    p.add_argument("--replicas", type=int, default=2,
                   help="number of serve replicas to launch")
    p.add_argument("--replica-prefix", default="r",
                   help="replica ids become <prefix><index>")
    p.add_argument("--ready-timeout", type=float, default=30.0,
                   help="seconds to wait for every /healthz")
    p.add_argument("--no-supervise", action="store_true",
                   help="launch replicas without --supervise (default "
                        "is supervised workers, the production shape)")
    p.add_argument("--keep-survivors", action="store_true",
                   help="a replica that dies is logged and left dead "
                        "while the others keep serving; the launcher "
                        "exits 1 when signalled (default: stop the "
                        "fleet and exit 1 at the first death)")
    return p


def _suffix_path_args(extra: list[str], rid: str) -> list[str]:
    """Give per-replica file sinks distinct paths: two replicas
    dumping to the same --trace-dump would race the atomic rename."""
    out = list(extra)
    for i, a in enumerate(out):
        if a in ("--trace-dump", "--fault-listen") and i + 1 < len(out):
            out[i + 1] = f"{out[i + 1]}.{rid}"
    return out


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if "--" in argv:
        cut = argv.index("--")
        own, extra = argv[:cut], argv[cut + 1:]
    else:
        own, extra = argv, []
    args = make_parser().parse_args(own)
    logging.basicConfig(level=logging.INFO)
    if args.replicas < 1:
        make_parser().error("--replicas must be >= 1")

    procs: list[subprocess.Popen] = []
    replicas: list[dict] = []
    try:
        for i in range(args.replicas):
            rid = f"{args.replica_prefix}{i}"
            port, mport = _free_port(), _free_port()
            cmd = [sys.executable, "-m", SERVE_MOD,
                   "--port", str(port), "--metrics-port", str(mport),
                   "--replica-id", rid]
            if "--checkpoint" not in extra:
                cmd.append("--tiny")
            if not args.no_supervise and "--supervise" not in extra:
                cmd.append("--supervise")
            cmd += _suffix_path_args(extra, rid)
            log.info("launching %s: %s", rid, " ".join(cmd))
            procs.append(subprocess.Popen(cmd))
            replicas.append({
                "id": rid,
                "url": f"http://127.0.0.1:{port}",
                "metrics_url": f"http://127.0.0.1:{mport}",
                "pid": procs[-1].pid,
            })

        deadline = time.monotonic() + args.ready_timeout
        for rep in replicas:
            if not _wait_healthy(rep["url"], deadline):
                log.error("replica %s never became healthy", rep["id"])
                return 1

        print(json.dumps({"kind": "fleet", "replicas": replicas}),
              flush=True)
        log.info("fleet up: %d replicas; metrics at %s",
                 len(replicas),
                 ",".join(r["metrics_url"] for r in replicas))

        stop = {"sig": None}

        def _on_term(signum, frame):
            stop["sig"] = signum

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
        dead: set[str] = set()
        while stop["sig"] is None:
            for rep, proc in zip(replicas, procs):
                rc = proc.poll()
                if rc is not None and rep["id"] not in dead:
                    log.error("replica %s (pid %d) exited rc=%d",
                              rep["id"], proc.pid, rc)
                    if not args.keep_survivors:
                        return 1
                    dead.add(rep["id"])
            time.sleep(0.25)
        log.info("signal %s: stopping fleet", stop["sig"])
        return 1 if dead else 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 10.0
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1,
                                      deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    raise SystemExit(main())
