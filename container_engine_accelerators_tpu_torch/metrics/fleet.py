"""Fleet telemetry plane, the port's copy of the JAX package's
metrics/fleet.py: scrape N serve replicas, keep a versioned fleet state
table, re-export aggregates, and diagnose fleet-level faults with the
SAME incident machinery the single-engine doctor uses. The metric
families, the fleet/* events and the snapshot contract are the JAX
package's, so fleetmon of either package scrapes replicas of either.

A router needs observability ACROSS engines: it routes by live KV-page
headroom and queue depth scraped from each replica's /metrics, and
replica lifecycle is driven by doctor verdicts. This module is that
substrate, playing the reference repo's metrics.go +
node-problem-detector role one level up — per-replica signal in,
fleet-level verdicts out:

    FleetScraper   polls each replica's /metrics (unlabelled families)
                   + /debugz?state=1 (the machine-readable engine
                   snapshot cli/serve.py publishes: queue depths per
                   pool, KV-page headroom, prefix hit rate,
                   worker_alive, restarts, host_gap_fraction) on a
                   thread OFF every engine tick path
    FleetState     versioned, thread-safe replica table; a torn or
                   unreachable scrape degrades that replica to
                   stale -> down instead of crashing the poller, and
                   the last good snapshot is RETAINED so a verdict can
                   still say what the replica was doing when it died
    FleetExporter  re-exports fleet_replicas{state}, aggregate
                   headroom/queue/prefix-hit gauges and per-replica
                   labeled mirrors on its own port (cli/fleetmon.py) —
                   replica labels live HERE, never on the per-engine
                   exporters, so single-engine scrapes stay unlabeled
    detectors      replica_down / fleet_imbalance / fleet_slo_burn over
                   the fleet/* flight-recorder counters the scraper
                   emits — registered in doctor.default_detectors(),
                   so live fleetmon verdicts, chaos replay and
                   `trace doctor` share one diagnosis engine

Scrape health is part of the signal: every poll lands fleet/replica/
<rid> counter samples (state level 2/1/0 plus the routing inputs) and
failures land fleet/scrape_error instants, which is what makes the
fleet detectors replayable from a fleetmon trace dump alone.

No torch imports here: fleetmon runs on hosts without it, the same
contract as metrics/doctor.py.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.metrics.doctor import (
    Detector,
    Finding,
    _evidence_event,
)
from container_engine_accelerators_tpu_torch.metrics.serving import ExporterBase

log = logging.getLogger(__name__)

STATE_UP = "up"
STATE_STALE = "stale"
STATE_DOWN = "down"
STATES = (STATE_UP, STATE_STALE, STATE_DOWN)
# Numeric levels so replica state rides Chrome counter tracks (and the
# detectors compare numbers, not strings): up=2, stale=1, down=0.
STATE_LEVEL = {STATE_UP: 2, STATE_STALE: 1, STATE_DOWN: 0}

# Families a well-formed serve replica /metrics body always carries —
# a body missing them (or cut before the trailing newline) is a TORN
# scrape from a replica mid-restart, not an idle replica.
DEFAULT_REQUIRED_FAMILIES = ("serve_queue_depth",)


class ScrapeError(RuntimeError):
    """One replica's scrape failed (unreachable, reset, torn body).
    Degrades that replica's state; never propagates out of a poll."""


def parse_metrics_text(text: str, required=()) -> dict[str, float]:
    """Prometheus text format -> {family: value} for UNLABELLED samples
    (the serve exporter's gauges/counters the router consumes). Raises
    ScrapeError on a torn body: empty, missing the trailing newline a
    complete exposition always ends with, or missing a required family
    — the mid-restart partial-read case."""
    if not text:
        raise ScrapeError("empty /metrics body")
    if not text.endswith("\n"):
        raise ScrapeError("torn /metrics body (no trailing newline)")
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2 or "{" in parts[0]:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    for fam in required:
        if fam not in out:
            raise ScrapeError(f"/metrics body missing {fam} "
                              "(partial scrape?)")
    return out


class ReplicaState:
    """One replica's row in the fleet table: scrape bookkeeping plus
    the last good /debugz state snapshot and parsed /metrics families.
    Mutated only under the owning FleetState's lock."""

    def __init__(self, rid: str, url: str, now: float):
        self.rid = rid
        self.url = url
        self.state = STATE_STALE  # unproven until the first ok scrape
        self.first_seen_ts = now
        self.last_ok_ts: float | None = None
        self.last_attempt_ts = now
        self.last_error: str | None = None
        self.consecutive_failures = 0
        self.transitions = 0
        self.snapshot: dict = {}
        self.metrics: dict = {}

    # -- accessors over snapshot-with-/metrics-fallback --

    def _snap(self, *keys, default=None):
        v: object = self.snapshot
        for k in keys:
            if not isinstance(v, dict):
                return default
            v = v.get(k)
        return default if v is None else v

    def queue_depth(self) -> float:
        q = self._snap("queued")
        if q is None:
            q = self.metrics.get("serve_queue_depth", 0.0)
        return float(q)

    def active_slots(self) -> float:
        a = self._snap("slots", "active")
        if a is None:
            a = self.metrics.get("serve_active_slots", 0.0)
        return float(a)

    def kv_pages(self) -> tuple[float, float]:
        used = self._snap("kv_pages", "used")
        total = self._snap("kv_pages", "total")
        if used is None:
            used = self.metrics.get("serve_kv_pages_in_use", 0.0)
        if total is None:
            total = self.metrics.get("serve_kv_pages_total", 0.0)
        return float(used), float(total)

    def kv_headroom(self) -> float:
        used, total = self.kv_pages()
        return max(total - used, 0.0)

    def prefix_cache(self) -> tuple[float, float]:
        """(lookups, hits) over the replica's lifetime."""
        lk = self._snap("prefix_cache", "lookups")
        hits = self._snap("prefix_cache", "hits")
        if lk is None:
            lk = self.metrics.get("serve_prefix_lookups", 0.0)
        if hits is None:
            hits = self.metrics.get("serve_prefix_hits", 0.0)
        return float(lk), float(hits)

    def host_gap(self) -> float | None:
        g = self._snap("host_gap_fraction")
        if g is None:
            g = self.metrics.get("serve_host_gap_fraction")
        return None if g is None else float(g)

    def slo_window(self, kind: str) -> tuple[int, int]:
        """(n, bad) for the replica's rolling TTFT/TPOT SLO window
        (request_metrics.state_snapshot publishes them)."""
        n = self._snap("slo_windows", kind, "n", default=0)
        bad = self._snap("slo_windows", kind, "bad", default=0)
        return int(n), int(bad)

    def kv_cold_pages(self) -> float | None:
        """Cold-bucket page count from the replica's thermal census.
        None when the replica predates the kv_thermal
        snapshot block or runs a non-paged engine — a mixed-version
        fleet must stay green, so absence is not an error."""
        v = self._snap("kv_thermal", "buckets", "cold")
        return None if v is None else float(v)

    def kv_working_set(self) -> float | None:
        v = self._snap("kv_thermal", "working_set_pages")
        return None if v is None else float(v)

    def fabric_score(self) -> float | None:
        """Worst-axis fabric health score from the replica's
        FabricHealthMonitor snapshot. None when the
        replica predates the fabric block or runs without the
        monitor — mixed-version fleets must stay green."""
        v = self._snap("fabric", "score")
        return None if v is None else float(v)

    def fabric_degraded(self) -> float | None:
        v = self._snap("fabric", "degraded")
        return None if v is None else float(v)

    def fabric_worst_axis(self) -> str | None:
        v = self._snap("fabric", "worst_axis")
        return None if v is None else str(v)

    def fabric_slow_rank(self):
        return self._snap("fabric", "slow_rank")

    def series_values(self) -> dict:
        """The fleet/replica/<rid> counter sample: the routing inputs
        plus liveness, all numeric (Chrome counter tracks)."""
        used, total = self.kv_pages()
        out = {
            "state": STATE_LEVEL[self.state],
            "queued": self.queue_depth(),
            "active": self.active_slots(),
            "kv_free": max(total - used, 0.0),
            "kv_total": total,
            "requests": float(self._snap("requests_served", default=0)),
            "restarts": float(self._snap("worker_restarts", default=0)),
            "worker_alive": 1.0 if self._snap("worker_alive") else 0.0,
        }
        cold = self.kv_cold_pages()
        if cold is not None:  # absent on pre-thermal replicas
            out["cold_pages"] = cold
        fscore = self.fabric_score()
        if fscore is not None:  # absent on pre-fabric-plane replicas
            out["fabric_score"] = fscore
            out["fabric_degraded"] = self.fabric_degraded() or 0.0
        return out

    def row(self, now: float) -> dict:
        """Debug row for fleetmon's own /debugz?state=1."""
        return {
            "replica": self.rid, "url": self.url, "state": self.state,
            "staleness_s": (round(now - self.last_ok_ts, 3)
                            if self.last_ok_ts is not None else None),
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
            "transitions": self.transitions,
            "queued": self.queue_depth(),
            "kv_headroom_pages": self.kv_headroom(),
            "worker_alive": bool(self._snap("worker_alive")),
            "snapshot": self.snapshot,
        }


class FleetState:
    """Versioned replica table. Thread-safe: the poll thread writes,
    fleetmon's HTTP thread reads via debugz()/aggregates(). Every
    observation bumps `version`, so a consumer (a router) can
    tell a fresh table from a stalled poller."""

    def __init__(self, down_after_s: float = 5.0):
        self.down_after_s = down_after_s
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaState] = {}
        self.version = 0

    def _get(self, rid: str, url: str, now: float) -> ReplicaState:
        r = self._replicas.get(rid)
        if r is None:
            r = self._replicas[rid] = ReplicaState(rid, url, now)
        return r

    def observe_ok(self, rid: str, url: str, snapshot: dict,
                   metrics: dict, now: float | None = None
                   ) -> tuple[str, str]:
        """Record a successful scrape; returns (prev_state, new_state)
        so the caller can emit a transition instant."""
        now = time.monotonic() if now is None else now
        with self._lock:
            r = self._get(rid, url, now)
            prev = r.state
            r.state = STATE_UP
            r.last_ok_ts = now
            r.last_attempt_ts = now
            r.last_error = None
            r.consecutive_failures = 0
            r.snapshot = snapshot or {}
            r.metrics = metrics or {}
            if prev != r.state:
                r.transitions += 1
            self.version += 1
            return prev, r.state

    def observe_failure(self, rid: str, url: str, error: str,
                        now: float | None = None) -> tuple[str, str]:
        """Record a failed scrape: stale immediately, down once no ok
        scrape has landed for down_after_s. The last good snapshot is
        kept — 'what was it doing when it died' is the replica_down
        detector's evidence."""
        now = time.monotonic() if now is None else now
        with self._lock:
            r = self._get(rid, url, now)
            prev = r.state
            r.last_attempt_ts = now
            r.last_error = str(error)
            r.consecutive_failures += 1
            ref = (r.last_ok_ts if r.last_ok_ts is not None
                   else r.first_seen_ts)
            r.state = (STATE_DOWN if now - ref >= self.down_after_s
                       else STATE_STALE)
            if prev != r.state:
                r.transitions += 1
            self.version += 1
            return prev, r.state

    def remove(self, rid: str) -> None:
        """Clean decommission: a replica deliberately taken out of the
        scrape set never becomes a replica_down verdict."""
        with self._lock:
            if self._replicas.pop(rid, None) is not None:
                self.version += 1

    def replicas(self) -> list[ReplicaState]:
        with self._lock:
            return list(self._replicas.values())

    def aggregates(self, now: float | None = None) -> dict:
        """Fleet-level rollup over UP replicas (stale/down rows only
        contribute their state count — routing on a dead replica's
        retained snapshot would be routing on fiction). The prefix hit
        rate is lookup-weighted, not a mean of per-replica rates."""
        now = time.monotonic() if now is None else now
        with self._lock:
            counts = {s: 0 for s in STATES}
            headroom = queue = 0.0
            lookups = hits = 0.0
            slo = {"ttft": {"n": 0, "bad": 0},
                   "tpot": {"n": 0, "bad": 0}}
            cold_total: float | None = None
            coldest_rid: str | None = None
            coldest_pages = -1.0
            fabric_degraded_total: float | None = None
            fabric_worst_rid: str | None = None
            fabric_worst_axis: str | None = None
            fabric_worst_score = 2.0
            for r in self._replicas.values():
                counts[r.state] += 1
                if r.state != STATE_UP:
                    continue
                headroom += r.kv_headroom()
                queue += r.queue_depth()
                lk, h = r.prefix_cache()
                lookups += lk
                hits += h
                cold = r.kv_cold_pages()
                if cold is not None:
                    cold_total = (cold_total or 0.0) + cold
                    if cold > coldest_pages:
                        coldest_pages = cold
                        coldest_rid = r.rid
                fscore = r.fabric_score()
                if fscore is not None:
                    fabric_degraded_total = (
                        (fabric_degraded_total or 0.0)
                        + (r.fabric_degraded() or 0.0))
                    if fscore < fabric_worst_score:
                        fabric_worst_score = fscore
                        fabric_worst_rid = r.rid
                        fabric_worst_axis = r.fabric_worst_axis()
                for kind in ("ttft", "tpot"):
                    n, bad = r.slo_window(kind)
                    slo[kind]["n"] += n
                    slo[kind]["bad"] += bad
            return {
                "ts_monotonic": now,
                "version": self.version,
                "replicas": counts,
                "kv_headroom_pages": headroom,
                "queue_depth": queue,
                "prefix_lookups": lookups,
                "prefix_hit_rate": (hits / lookups) if lookups else None,
                "slo": slo,
                # Thermal rollup: None when NO up replica
                # publishes kv_thermal yet (mixed-version fleet) —
                # distinct from a genuine 0 cold pages.
                "kv_cold_pages": cold_total,
                "coldest_replica": coldest_rid,
                # Fabric rollup: None when NO up replica
                # publishes a fabric block yet (mixed-version fleet) —
                # distinct from a genuine 0 degraded axes.
                "fabric_degraded": fabric_degraded_total,
                "fabric_worst_replica": fabric_worst_rid,
                "fabric_worst_axis": fabric_worst_axis,
                "fabric_worst_score": (
                    None if fabric_worst_rid is None
                    else fabric_worst_score),
            }

    def debugz(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            rows = [r.row(now) for r in self._replicas.values()]
            version = self.version
        return {"version": version, "down_after_s": self.down_after_s,
                "replicas": rows}


class FleetScraper:
    """Polls each (replica_id, endpoint) pair and folds the results
    into a FleetState. `poll_once()` is HTTP-in, events-out and never
    raises: per-replica failures degrade that row and land a
    fleet/scrape_error instant. Runs on FleetExporter's poll thread in
    production; tests and the perf gate drive it directly."""

    def __init__(self, endpoints, replica_ids=None,
                 state: FleetState | None = None, timeout_s: float = 2.0,
                 down_after_s: float = 5.0,
                 required_families=DEFAULT_REQUIRED_FAMILIES):
        endpoints = list(endpoints)
        if replica_ids is None:
            replica_ids = [f"r{i}" for i in range(len(endpoints))]
        replica_ids = list(replica_ids)
        if len(replica_ids) != len(endpoints):
            raise ValueError(
                f"{len(replica_ids)} replica ids for "
                f"{len(endpoints)} endpoints")
        self.targets: list[tuple[str, str]] = list(
            zip(replica_ids, endpoints))
        self.state = state or FleetState(down_after_s=down_after_s)
        self.timeout_s = timeout_s
        self.required_families = tuple(required_families)
        self.polls = 0
        self.scrape_errors = 0
        self.last_outcomes: dict[str, str] = {}

    def _get(self, url: str) -> str:
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8", errors="replace")

    def scrape_one(self, url: str) -> tuple[dict, dict]:
        """(state snapshot, parsed /metrics families) for one replica;
        any failure — refused, reset, timeout, torn body, bad JSON —
        surfaces as ScrapeError."""
        base = url.rstrip("/")
        try:
            metrics = parse_metrics_text(
                self._get(base + "/metrics"),
                required=self.required_families)
            # n=0 skips the event backlog: the scraper wants the state
            # snapshot, not the replica's flight-recorder tail.
            raw = json.loads(self._get(base + "/debugz?n=0&state=1"))
            snapshot = raw.get("state") or {}
            if not isinstance(snapshot, dict):
                raise ScrapeError("malformed /debugz state payload")
        except ScrapeError:
            raise
        except Exception as e:
            raise ScrapeError(f"{type(e).__name__}: {e}") from e
        return snapshot, metrics

    def poll_once(self, now: float | None = None) -> dict:
        """One scrape cycle over every target; returns the aggregate
        rollup. Emission (fleet/* counters + instants) happens only
        when the flight recorder is on."""
        now = time.monotonic() if now is None else now
        self.polls += 1
        for rid, url in self.targets:
            try:
                snapshot, metrics = self.scrape_one(url)
            except ScrapeError as e:
                self.scrape_errors += 1
                self.last_outcomes[rid] = "error"
                prev, cur = self.state.observe_failure(
                    rid, url, str(e), now=now)
                if events.enabled():
                    events.instant("fleet/scrape_error", "fleet",
                                   {"replica": rid,
                                    "error": str(e)[:200]})
            else:
                self.last_outcomes[rid] = "ok"
                prev, cur = self.state.observe_ok(
                    rid, url, snapshot, metrics, now=now)
            if prev != cur and events.enabled():
                events.instant("fleet/replica_state", "fleet",
                               {"replica": rid, "from": prev, "to": cur,
                                "level": STATE_LEVEL[cur]})
        agg = self.state.aggregates(now=now)
        if events.enabled():
            for r in self.state.replicas():
                events.counter(f"fleet/replica/{r.rid}",
                               r.series_values(), "fleet")
            events.counter("fleet/replicas",
                           dict(agg["replicas"]), "fleet")
            for kind in ("ttft", "tpot"):
                events.counter(f"fleet/slo_{kind}",
                               dict(agg["slo"][kind]), "fleet")
        return agg


class FleetExporter(ExporterBase):
    """fleetmon's exporter: owns the scrape cadence (ExporterBase's
    poll thread drives FleetScraper.poll_once) and re-exports the
    rollup plus per-replica labeled mirrors on its own port. The
    replica label space lives here, one hop removed from the engines,
    so per-engine scrape parsers stay unlabeled (chip_smoke.py's
    _scrape, parse_metrics_text above)."""

    name = "fleetmon"

    def __init__(self, scraper: FleetScraper, port: int = 0,
                 host: str = "", interval: float = 1.0, registry=None):
        from prometheus_client import CollectorRegistry, Counter, Gauge

        self.scraper = scraper
        self.registry = registry or CollectorRegistry()
        self.port = port
        self.host = host
        self.interval = interval
        self._stop = threading.Event()
        reg = self.registry
        self.replicas_g = Gauge(
            "fleet_replicas", "Replicas by scrape-derived state",
            ["state"], registry=reg)
        for s in STATES:  # materialize all three, zeros included
            self.replicas_g.labels(s)
        self.headroom_g = Gauge(
            "fleet_kv_headroom_pages",
            "Free KV pool pages summed over UP replicas — the router's "
            "primary admission signal", registry=reg)
        self.queue_g = Gauge(
            "fleet_queue_depth",
            "Queued requests summed over UP replicas", registry=reg)
        self.prefix_g = Gauge(
            "fleet_prefix_hit_rate",
            "Lookup-weighted prefix-cache hit rate over UP replicas",
            registry=reg)
        self.version_g = Gauge(
            "fleet_state_version",
            "FleetState table version; a flat-lining version means the "
            "poller itself is stuck", registry=reg)
        self.r_state = Gauge(
            "fleet_replica_state",
            "Per-replica state level (2=up, 1=stale, 0=down)",
            ["replica"], registry=reg)
        self.r_queue = Gauge(
            "fleet_replica_queue_depth",
            "Per-replica queued requests (last good snapshot)",
            ["replica"], registry=reg)
        self.r_headroom = Gauge(
            "fleet_replica_kv_headroom_pages",
            "Per-replica free KV pool pages (last good snapshot)",
            ["replica"], registry=reg)
        self.r_prefix = Gauge(
            "fleet_replica_prefix_hit_rate",
            "Per-replica prefix-cache hit rate (lifetime)",
            ["replica"], registry=reg)
        self.r_hostgap = Gauge(
            "fleet_replica_host_gap_fraction",
            "Per-replica exposed-host fraction (the serve_host_gap_"
            "fraction gauge, mirrored fleet-wide)", ["replica"],
            registry=reg)
        self.r_restarts = Gauge(
            "fleet_replica_worker_restarts",
            "Per-replica supervisor worker restarts", ["replica"],
            registry=reg)
        self.r_staleness = Gauge(
            "fleet_replica_staleness_seconds",
            "Seconds since the replica's last successful scrape",
            ["replica"], registry=reg)
        # Thermal rollup: the router/offload signal — how
        # much HBM fleet-wide sits on cold pages, and which replica
        # holds the most (fleet_kv_coldest_replica carries the rid as
        # a label with value 1).
        self.cold_g = Gauge(
            "fleet_kv_cold_pages",
            "Cold-bucket KV pages summed over UP replicas publishing "
            "a thermal census (0 until any replica does)", registry=reg)
        self.r_cold = Gauge(
            "fleet_replica_kv_cold_pages",
            "Per-replica cold-bucket KV pages (last good snapshot; "
            "absent for replicas without a thermal census)",
            ["replica"], registry=reg)
        self.coldest_g = Gauge(
            "fleet_kv_coldest_replica",
            "1 on the UP replica holding the most cold KV pages, 0 "
            "elsewhere — the offload/routing attribution target",
            ["replica"], registry=reg)
        # Fabric rollup: how many degraded axes fleet-wide,
        # each replica's worst-axis health score, and which replica
        # holds the worst fabric (the drain/route-around target —
        # fleet_fabric_worst_replica carries the rid as a label with
        # value 1).
        self.fabric_degraded_g = Gauge(
            "fleet_fabric_degraded",
            "Degraded fabric axes summed over UP replicas publishing "
            "a fabric-health block (0 until any replica does)",
            registry=reg)
        self.r_fabric = Gauge(
            "fleet_replica_fabric_health",
            "Per-replica worst-axis fabric health score (last good "
            "snapshot; absent for replicas without the fabric plane)",
            ["replica"], registry=reg)
        self.fabric_worst_g = Gauge(
            "fleet_fabric_worst_replica",
            "1 on the UP replica with the worst fabric health score, "
            "0 elsewhere — the drain/route-around attribution target",
            ["replica"], registry=reg)
        self.scrapes = Counter(
            "fleet_scrapes", "Scrape attempts by replica and outcome",
            ["replica", "outcome"], registry=reg)
        # fleetmon's own /debugz?state=1 serves the replica table — the
        # same machine-readable contract the replicas serve fleetmon.
        self.state_provider = self.scraper.state.debugz

    def poll_once(self) -> None:
        agg = self.scraper.poll_once()
        for rid, outcome in self.scraper.last_outcomes.items():
            self.scrapes.labels(replica=rid, outcome=outcome).inc()
        for s in STATES:
            self.replicas_g.labels(s).set(agg["replicas"][s])
        self.headroom_g.set(agg["kv_headroom_pages"])
        self.queue_g.set(agg["queue_depth"])
        if agg["prefix_hit_rate"] is not None:
            self.prefix_g.set(agg["prefix_hit_rate"])
        self.version_g.set(agg["version"])
        self.cold_g.set(agg.get("kv_cold_pages") or 0.0)
        coldest = agg.get("coldest_replica")
        self.fabric_degraded_g.set(agg.get("fabric_degraded") or 0.0)
        fabric_worst = agg.get("fabric_worst_replica")
        now = time.monotonic()
        for r in self.scraper.state.replicas():
            lab = r.rid
            self.r_state.labels(lab).set(STATE_LEVEL[r.state])
            self.r_queue.labels(lab).set(r.queue_depth())
            self.r_headroom.labels(lab).set(r.kv_headroom())
            lk, hits = r.prefix_cache()
            if lk:
                self.r_prefix.labels(lab).set(hits / lk)
            gap = r.host_gap()
            if gap is not None:
                self.r_hostgap.labels(lab).set(gap)
            cold = r.kv_cold_pages()
            if cold is not None:
                self.r_cold.labels(lab).set(cold)
            self.coldest_g.labels(lab).set(
                1.0 if lab == coldest else 0.0)
            fscore = r.fabric_score()
            if fscore is not None:
                self.r_fabric.labels(lab).set(fscore)
            self.fabric_worst_g.labels(lab).set(
                1.0 if lab == fabric_worst else 0.0)
            self.r_restarts.labels(lab).set(
                r.series_values()["restarts"])
            if r.last_ok_ts is not None:
                self.r_staleness.labels(lab).set(
                    max(0.0, now - r.last_ok_ts))


# ---------- fleet-level detectors (metrics/doctor.py registry) ----------

class ReplicaDownDetector(Detector):
    """A replica whose scrapes died WITH live traffic at last contact:
    the latest fleet/replica/<rid> sample is state=down and an earlier
    up sample inside the slow window shows queued/active/served
    traffic. A replica cleanly removed from the scrape set stops
    emitting samples instead of going down, so decommissions stay
    quiet (FleetState.remove)."""

    cls = "replica_down"

    def check(self, sig):
        out = []
        groups = sig.counter_groups("fleet/replica/", sig.slow_since)
        for rid, series in groups.items():
            ts_last, last = series[-1]
            if last.get("state", STATE_LEVEL[STATE_UP]) != 0:
                continue
            up_traffic = [
                (ts, v) for ts, v in series
                if v.get("state") == STATE_LEVEL[STATE_UP]
                and (v.get("queued", 0) > 0 or v.get("active", 0) > 0
                     or v.get("requests", 0) > 0)]
            if not up_traffic:
                continue
            ts_up, v_up = up_traffic[-1]
            # Down-for: the trailing run of state=0 samples.
            down_since = ts_last
            for ts, v in reversed(series):
                if v.get("state") != 0:
                    break
                down_since = ts
            ev = {
                "replica": rid,
                "down_for_s": round(sig.now - down_since, 3),
                "last_up_s_ago": round(sig.now - ts_up, 3),
                "last_traffic": {k: v_up.get(k) for k in
                                 ("queued", "active", "requests")},
                "events": [
                    _evidence_event({"name": f"fleet/replica/{rid}",
                                     "ph": "C", "ts": ts_up,
                                     "args": v_up}),
                    _evidence_event({"name": f"fleet/replica/{rid}",
                                     "ph": "C", "ts": ts_last,
                                     "args": last})],
            }
            errs = [e for e in sig.named("fleet/scrape_error", "i",
                                         sig.slow_since)
                    if e["args"].get("replica") == rid]
            if errs:
                ev["scrape_error"] = errs[-1]["args"].get("error")
                ev["events"].append(_evidence_event(errs[-1]))
            out.append(Finding(
                self.cls, rid,
                f"replica {rid} unreachable for "
                f"{ev['down_for_s']:.1f}s with live traffic at last "
                f"contact ({ev['last_traffic']})", 0.9, ev))
        return out


class FleetImbalanceDetector(Detector):
    """Sustained load skew across UP replicas beyond a band: one
    replica's queue runs fleet_imbalance_queue deeper than the
    lightest's, or its KV headroom fraction runs
    fleet_imbalance_headroom_frac below the freest's, across the whole
    fast window with strictly separated sample ranges (a crossing
    transient is rebalancing working, not a verdict). Needs at least
    two UP replicas with fleet_imbalance_min_samples each — after a
    kill, the one-survivor fleet is skewed by definition and must stay
    quiet here (that's replica_down's story)."""

    cls = "fleet_imbalance"

    def _up_series(self, sig) -> dict[str, list[dict]]:
        out = {}
        for rid, series in sig.counter_groups(
                "fleet/replica/", sig.fast_since).items():
            ups = [v for _, v in series
                   if v.get("state") == STATE_LEVEL[STATE_UP]]
            if len(ups) >= sig.config.fleet_imbalance_min_samples:
                out[rid] = ups
        return out

    def check(self, sig):
        ups = self._up_series(sig)
        if len(ups) < 2:
            return []
        out = []
        q = {rid: [float(v.get("queued", 0)) for v in vs]
             for rid, vs in ups.items()}
        means = {rid: sum(xs) / len(xs) for rid, xs in q.items()}
        worst = max(means, key=lambda r: means[r])
        best = min(means, key=lambda r: means[r])
        gap = means[worst] - means[best]
        if (gap >= sig.config.fleet_imbalance_queue
                and min(q[worst]) > max(q[best])):
            out.append(Finding(
                self.cls, worst,
                f"replica {worst} queue runs {gap:.1f} deeper than "
                f"{best} across the whole "
                f"{sig.config.fast_window_s:.0f}s window "
                f"({means[worst]:.1f} vs {means[best]:.1f})", 0.8,
                {"dimension": "queue_depth", "worst": worst,
                 "best": best, "gap": round(gap, 2),
                 "means": {r: round(m, 2) for r, m in means.items()},
                 "window_s": sig.config.fast_window_s,
                 "samples": {r: len(xs) for r, xs in q.items()}}))
        h = {}
        for rid, vs in ups.items():
            fracs = [float(v.get("kv_free", 0)) / float(v["kv_total"])
                     for v in vs if float(v.get("kv_total", 0) or 0) > 0]
            if len(fracs) >= sig.config.fleet_imbalance_min_samples:
                h[rid] = fracs
        if len(h) >= 2:
            hmeans = {rid: sum(xs) / len(xs) for rid, xs in h.items()}
            worst = min(hmeans, key=lambda r: hmeans[r])
            best = max(hmeans, key=lambda r: hmeans[r])
            gap = hmeans[best] - hmeans[worst]
            if (gap >= sig.config.fleet_imbalance_headroom_frac
                    and max(h[worst]) < min(h[best])):
                out.append(Finding(
                    self.cls, worst,
                    f"replica {worst} KV headroom runs "
                    f"{gap * 100:.0f}pp below {best} across the whole "
                    f"{sig.config.fast_window_s:.0f}s window "
                    f"({hmeans[worst]:.2f} vs {hmeans[best]:.2f})",
                    0.75,
                    {"dimension": "kv_headroom_frac", "worst": worst,
                     "best": best, "gap": round(gap, 3),
                     "means": {r: round(m, 3)
                               for r, m in hmeans.items()},
                     "window_s": sig.config.fast_window_s}))
        return out


class FleetSloBurnDetector(Detector):
    """Aggregate error-budget burn over the fleet: the scraper sums
    every UP replica's rolling TTFT/TPOT window into fleet/slo_<kind>
    counter samples ({n, bad}); this detector converts each sample to
    a burn rate ((bad/n)/budget) and requires the MEAN burn over both
    the fast and slow windows above the SloSpec thresholds. The mean —
    not a sum — because consecutive samples re-observe one overlapping
    rolling window; summing would count each slow request once per
    scrape."""

    cls = "fleet_slo_burn"

    def check(self, sig):
        out = []
        for spec in sig.config.slos:
            if spec.kind not in ("ttft", "tpot"):
                continue
            series = sig.series(f"fleet/slo_{spec.kind}")
            if not series:
                continue
            budget = max(1e-6, 1.0 - spec.objective)

            def burn_over(since):
                rates = [(v.get("bad", 0) / v["n"]) / budget
                         for ts, v in series
                         if ts >= since and v.get("n", 0) > 0]
                return ((sum(rates) / len(rates), len(rates))
                        if rates else (0.0, 0))

            fast, k_fast = burn_over(sig.fast_since)
            slow, _ = burn_over(sig.slow_since)
            n_latest = series[-1][1].get("n", 0)
            if k_fast == 0 or n_latest < spec.min_samples:
                continue
            if fast < spec.fast_burn or slow < spec.slow_burn:
                continue
            out.append(Finding(
                self.cls, f"fleet/{spec.name}",
                f"fleet-wide SLO {spec.name} burning error budget at "
                f"{fast:.1f}x (fast) / {slow:.1f}x (slow) the "
                f"sustainable rate over {n_latest} windowed samples",
                0.8,
                {"slo": spec.name, "kind": spec.kind,
                 "objective": spec.objective,
                 "threshold_s": spec.threshold_s,
                 "burn_fast": round(fast, 2),
                 "burn_slow": round(slow, 2),
                 "samples_latest_window": n_latest,
                 "scrape_samples_fast": k_fast,
                 "windows_s": [sig.config.fast_window_s,
                               sig.config.slow_window_s]}))
        return out


def fleet_detectors() -> list[Detector]:
    """The fleet registry slice doctor.default_detectors() appends —
    quiet in any process that never runs a FleetScraper (the fleet/*
    event namespace simply doesn't exist there)."""
    return [ReplicaDownDetector(), FleetImbalanceDetector(),
            FleetSloBurnDetector()]
