"""Fabric metrics exporter: the JAX package's `metrics/fabric.py`, the
analog of the reference's vendor fabric-metrics DaemonSet (reference
gpudirect-tcpx/tcpx-metrics-server.yaml), with JAX's flags and families.
The card's duty cycle (metrics/metrics.py) says the SMs are busy; only
fabric counters say the interconnect is healthy.

Sources:
  - Host NICs: per-interface byte/packet/drop counters from
    /sys/class/net/<if>/statistics (traffic between hosts rides them),
    exported raw plus a throughput gauge over the poll window.
  - NVLink: where the JAX package reads /sys/class/accel/<chip>/
    ici_errors, this reads each card's NVLink error counters through
    NVML (utils/nvml.py: nvmlDeviceGetNvLinkState and
    nvmlDeviceGetNvLinkErrorCounter, summed over the active links) and
    exports them under JAX's `tpu_ici_error_count{tpu_chip}`, the chip
    named `nvidia<minor>`. Where NVML answers Not Supported (or cannot
    be loaded) the gauge stays unset, as JAX's does without the sysfs
    file; `nvlink_answers` keeps what NVML said.
  - An optional TCP RTT probe of a dcn-prober echo port.
  - An opt-in, rate-limited collective probe hook
    (ops/collectives.make_probe_hook).

Serves Prometheus on :2113/metrics (the card exporter owns :2112).
`--health` co-registers a FabricHealthMonitor (metrics/fabric_health.py)
on this registry, over the process's group (`--backend` nccl on the
card, gloo on the CPU), and runs the probe hook over the same group.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time

from prometheus_client import CollectorRegistry, Counter, Gauge

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.metrics.serving import (
    ExporterBase,
)

log = logging.getLogger(__name__)

DEFAULT_SYSFS_NET = "/sys/class/net"
STAT_FILES = ("tx_bytes", "rx_bytes", "tx_packets", "rx_packets",
              "tx_dropped", "rx_dropped")


def _read_int(path: str) -> int | None:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


class FabricMetricServer(ExporterBase):
    name = "fabric-metrics"

    def __init__(self, interfaces: list[str] | None = None,
                 sysfs_net: str = DEFAULT_SYSFS_NET, nvml=None,
                 probe_addr: tuple[str, int] | None = None,
                 port: int = 2113, interval: float = 10.0,
                 registry: CollectorRegistry | None = None,
                 collective_probe=None,
                 collective_probe_interval: float = 600.0):
        """`nvml`: an open utils/nvml.Nvml session, or None to open the
        library on the first poll (a host without it exports no NVLink
        counters)."""
        self.sysfs_net = sysfs_net
        self.interfaces = interfaces  # None = all non-loopback
        self.probe_addr = probe_addr
        self.port = port
        self.interval = interval
        self._stop = threading.Event()
        self._last: dict[tuple[str, str], tuple[int, float]] = {}
        self._nvml = nvml
        self._nvml_tried = nvml is not None
        self.nvlink_answers: dict[str, str] = {}
        # Opt-in active probe: a callable returning [(collective, axis,
        # fabric, busbw_bytes_per_second), ...]; legacy 3-tuples are
        # labelled 'ici'. It runs a real collective, so it is
        # rate-limited to one round per collective_probe_interval and
        # off by default.
        self.collective_probe = collective_probe
        self.collective_probe_interval = collective_probe_interval
        self._next_collective_probe = 0.0  # due on the first poll

        # Shared-registry mode: pass another exporter's registry to
        # co-serve these gauges on its port (its loop drives poll_once);
        # don't start_background() a sharing instance.
        self.registry = registry or CollectorRegistry()
        self.nic_counter = Gauge(
            "tpu_dcn_nic_stat",
            "Raw NIC counter from /sys/class/net (DCN datapath)",
            ["interface", "stat"], registry=self.registry)
        self.nic_throughput = Gauge(
            "tpu_dcn_throughput_bytes_per_sec",
            "Derived NIC throughput over the poll window",
            ["interface", "direction"], registry=self.registry)
        self.ici_errors = Gauge(
            "tpu_ici_error_count",
            "Interconnect error counter per card: NVLink data-link "
            "errors summed over active links (NVML, when it answers)",
            ["tpu_chip"], registry=self.registry)
        # Created on the first SUCCESSFUL probe: a registered but unset
        # Gauge exports 0.0, a fabricated perfect RTT while the target
        # is down.
        self.probe_rtt: Gauge | None = None
        self.probe_up = Gauge(
            "tpu_dcn_probe_up",
            "1 if the last dcn-prober TCP probe succeeded, else 0",
            [], registry=self.registry)
        self.scrapes = Counter(
            "tpu_fabric_poll_total", "Fabric poll iterations",
            [], registry=self.registry)
        self.probe_errors = Counter(
            "tpu_fabric_probe_errors_total",
            "Collective busBW probe invocations that raised (polling "
            "survives; the round is skipped)",
            [], registry=self.registry)
        self.collective_busbw = Gauge(
            "fabric_collective_busbw_bytes_per_second",
            "Measured collective bus bandwidth over a group's axis "
            "(nccl-tests busBW convention; ops/collectives probe via an "
            "opt-in rate-limited background hook). `fabric` is the "
            "interconnect the axis rides: 'ici' on a host (the card or "
            "NVLink), 'dcn' for a dp axis across hosts",
            ["collective", "axis", "fabric"], registry=self.registry)

    # ---------- collection ----------

    def _iter_interfaces(self) -> list[str]:
        if self.interfaces is not None:
            return self.interfaces
        try:
            names = sorted(os.listdir(self.sysfs_net))
        except OSError:
            return []
        return [n for n in names if n != "lo"]

    def _session(self):
        if not self._nvml_tried:
            self._nvml_tried = True
            from container_engine_accelerators_tpu_torch.utils import nvml
            try:
                self._nvml = nvml.Nvml()
            except nvml.NvmlError as e:
                log.info("no NVML (%s): NVLink counters not exported", e)
        return self._nvml

    def _poll_nvlink(self) -> None:
        from container_engine_accelerators_tpu_torch.utils import nvml

        session = self._session()
        if session is None:
            return
        try:
            cards = session.cards()
        except nvml.NvmlError as e:
            self.nvlink_answers["*"] = str(e)
            return
        for minor, card in sorted(cards.items()):
            chip = f"nvidia{minor}"
            try:
                errors = session.nvlink_errors(session.handle(card.index))
            except nvml.NvmlError as e:
                self.nvlink_answers[chip] = str(e)
                continue
            self.nvlink_answers[chip] = "ok"
            self.ici_errors.labels(tpu_chip=chip).set(errors)

    def poll_once(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        for iface in self._iter_interfaces():
            stats_dir = os.path.join(self.sysfs_net, iface, "statistics")
            for stat in STAT_FILES:
                val = _read_int(os.path.join(stats_dir, stat))
                if val is None:
                    continue
                self.nic_counter.labels(interface=iface, stat=stat).set(val)
                if stat in ("tx_bytes", "rx_bytes"):
                    key = (iface, stat)
                    prev = self._last.get(key)
                    if prev is not None and now > prev[1]:
                        rate = max(0.0, (val - prev[0]) / (now - prev[1]))
                        self.nic_throughput.labels(
                            interface=iface,
                            direction=stat.split("_")[0]).set(rate)
                    self._last[key] = (val, now)
        self._poll_nvlink()
        if self.probe_addr:
            self._probe()
        if (self.collective_probe is not None
                and now >= self._next_collective_probe):
            # Schedule the next round BEFORE running: a slow or hung
            # probe must not burst when polls catch up.
            self._next_collective_probe = (
                now + self.collective_probe_interval)
            try:
                for row in self.collective_probe():
                    if len(row) == 4:
                        coll, axis, fabric, busbw = row
                    else:  # legacy 3-tuple hook
                        (coll, axis, busbw), fabric = row, "ici"
                    self.collective_busbw.labels(
                        collective=coll, axis=axis,
                        fabric=fabric).set(busbw)
            except Exception as e:
                # A raising hook must not kill the poll thread: count
                # it, mark the timeline, keep polling.
                self.probe_errors.inc()
                if events.enabled():
                    events.instant("fabric/probe_error", "fabric",
                                   {"error": type(e).__name__,
                                    "detail": str(e)[:200]})
                log.exception("collective busBW probe failed")
        self.scrapes.inc()

    def _probe(self) -> None:
        t0 = time.monotonic()
        try:
            with socket.create_connection(self.probe_addr, timeout=2.0):
                rtt = time.monotonic() - t0
            if self.probe_rtt is None:
                self.probe_rtt = Gauge(
                    "tpu_dcn_probe_rtt_seconds",
                    "TCP RTT to the dcn-prober echo port (last "
                    "successful probe)", [], registry=self.registry)
            self.probe_rtt.set(rtt)
            self.probe_up.set(1)
        except OSError:
            self.probe_up.set(0)   # RTT gauge left stale, not sentineled

    def stop(self) -> None:
        super().stop()
        if self._nvml is not None:
            self._nvml.close()


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=2113)
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--interfaces", default="",
                   help="comma list; empty = all non-loopback")
    p.add_argument("--probe", default="",
                   help="host:port of a dcn-prober echo to RTT-probe")
    p.add_argument("--health", action="store_true",
                   help="also run a FabricHealthMonitor "
                        "(metrics/fabric_health.py) co-registered on "
                        "this server's registry (baseline-tracked probe "
                        "sweeps, degradation verdicts, slow-rank "
                        "localization) and the collective probe hook, "
                        "both over this process's group")
    p.add_argument("--health-interval", type=float, default=30.0,
                   help="seconds between fabric health probe sweeps")
    p.add_argument("--health-baseline", default=None,
                   help="FABRIC_BASELINE.json to seed/persist busBW "
                        "baselines")
    p.add_argument("--health-history", default=None,
                   help="append probe-history JSONL rows here "
                        "(tools/fabric_report.py input)")
    p.add_argument("--backend", default="nccl",
                   help="--health's torch.distributed backend: nccl (the "
                        "card) or gloo (the CPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    probe = None
    if args.probe:
        host, _, port = args.probe.rpartition(":")
        probe = (host, int(port))
    group = hook = None
    # The hook and the monitor probe from two threads over one group:
    # one at a time (a probe captures a CUDA graph on the card, and
    # matched collectives must not interleave).
    probe_lock = threading.Lock()
    if args.health:
        from container_engine_accelerators_tpu_torch.ops.collectives import (
            make_probe_hook,
        )
        from container_engine_accelerators_tpu_torch.parallel.distributed import (  # noqa: E501
            default_group,
        )
        group = default_group(args.backend)
        # ppermute beside JAX's pair: on one rank (n = 1) only it moves
        # bytes.
        probe_round = make_probe_hook(group, "dp", collectives=(
            "all_reduce", "all_gather", "ppermute"))

        def hook():
            with probe_lock:
                return probe_round()
    srv = FabricMetricServer(
        interfaces=[i for i in args.interfaces.split(",") if i] or None,
        probe_addr=probe, port=args.port, interval=args.interval,
        collective_probe=hook)
    mon = None
    if args.health:
        from container_engine_accelerators_tpu_torch.metrics import (
            fabric_health,
        )
        mon = fabric_health.FabricHealthMonitor(
            groups={"dp": group}, interval=args.health_interval,
            baseline_path=args.health_baseline,
            history_path=args.health_history,
            registry=srv.registry, sweep_lock=probe_lock)
        mon.start_poll_only()
        fabric_health.set_active(mon)
    srv.start_background()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        if mon is not None:
            mon.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
