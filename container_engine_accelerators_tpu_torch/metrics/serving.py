"""Shared Prometheus-exporter scaffold: WSGI server + poll thread +
Event-based stop, with a `/debugz` route beside `/metrics`. The serving
exporter (request_metrics.py) is built on it; the same routes and
payload keys as the JAX package's, so one dashboard reads either."""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
import wsgiref.simple_server

from prometheus_client import make_wsgi_app

log = logging.getLogger(__name__)

DEBUGZ_DEFAULT_LIMIT = 256
DEBUGZ_DEFAULT_CENSUS = 32


def attach_ring_gauges(registry) -> None:
    """Expose the process-wide EventBus ring accounting on a scrape
    registry: `tpu_trace_events_emitted_total` and
    `tpu_trace_events_dropped_total` (ring overwrites, the flight
    recorder's blind-spot counter). Values are read live at scrape time
    via set_function, so no poll loop is involved. Idempotent per
    registry: a second attach is a no-op."""
    from prometheus_client import Gauge

    from container_engine_accelerators_tpu_torch.metrics import events

    try:
        emitted = Gauge(
            "tpu_trace_events_emitted_total",
            "Events emitted onto the flight-recorder ring since start",
            registry=registry)
        dropped = Gauge(
            "tpu_trace_events_dropped_total",
            "Ring events overwritten before any dump/tap could read "
            "them — nonzero means the flight recorder has blind spots",
            registry=registry)
        tap_dropped = Gauge(
            "tpu_trace_tap_events_dropped_total",
            "Events lost to slow tap consumers (JSONL streamers) "
            "before they could drain — nonzero means "
            "streamed traces are truncated",
            registry=registry)
    except ValueError:
        return  # this registry already carries the ring gauges
    emitted.set_function(lambda: float(events.get_bus().emitted))
    dropped.set_function(lambda: float(events.get_bus().dropped))
    tap_dropped.set_function(lambda: float(events.get_bus().tap_dropped))


class _QuietHandler(wsgiref.simple_server.WSGIRequestHandler):
    def log_message(self, *args):
        pass


class ExporterBase:
    """Subclasses provide self.registry, self.port, self.interval, and
    poll_once(); this base owns the HTTP thread + poll loop + stop.

    port 0 binds an ephemeral port (the OS picks one) — `bound_port`
    holds the actual port after start_background(), so tests and CI
    never hard-code ports that can collide. The bind host comes from
    self.host when a subclass sets it; the default stays all-interfaces
    for parity with the reference exporters."""

    _stop: threading.Event
    name = "exporter"
    host = ""  # all interfaces, like the reference's :2112 listener
    # Optional /debugz providers (callables returning JSON-able dicts):
    # `?kv=1` and `?state=1` serve them when a subclass instance sets
    # them.
    kv_provider = None
    state_provider = None

    def poll_once(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _make_app(self):
        """Prometheus WSGI app plus a /debugz route serving the
        process-wide EventBus's last-N events as JSON (?n= to change N):
        the live window onto the flight recorder, on every exporter
        port, no dump file required. `?census=1` also embeds the
        allocator's live-block census (top-N by size; `census=<k>` with
        k>1 sets N), per-device memory stats and the kernel library's
        build record (metrics/introspection.py, kernels.build_record).
        `?doctor=1` embeds the streaming doctor's live verdicts (active
        incidents, recent incident history, SLO burn rates:
        metrics/doctor.py) when a doctor runs in this process. `?kv=1`
        embeds the paged engine's KV thermal census when the exporter
        has a `kv_provider` callable (cli/serve.py sets it). `?state=1`
        embeds the machine-readable engine-state snapshot, the fleet
        scraper's structured half of the scrape, when the exporter has
        a `state_provider` callable (cli/serve.py wires the recorder and
        engine snapshot; cli/fleetmon.py the FleetState table)."""
        prom = make_wsgi_app(self.registry)

        def app(environ, start_response):
            if environ.get("PATH_INFO", "") == "/debugz":
                body = json.dumps(self._debugz(
                    urllib.parse.parse_qs(environ.get("QUERY_STRING",
                                                      "")))).encode()
                start_response("200 OK", [
                    ("Content-Type", "application/json"),
                    ("Content-Length", str(len(body)))])
                return [body]
            return prom(environ, start_response)

        return app

    def _debugz(self, qs: dict) -> dict:
        from container_engine_accelerators_tpu_torch.metrics import events

        try:
            limit = int(qs.get("n", [DEBUGZ_DEFAULT_LIMIT])[0])
        except (TypeError, ValueError):
            limit = DEBUGZ_DEFAULT_LIMIT
        payload = events.get_bus().debugz(max(limit, 0))
        try:
            census_n = int(qs.get("census", [0])[0])
        except (TypeError, ValueError):
            census_n = 0
        if census_n > 0:
            # Imported here: they import torch, which fleetmon's
            # exporter (the same base) never needs.
            from container_engine_accelerators_tpu_torch import kernels
            from container_engine_accelerators_tpu_torch.metrics import (
                introspection,
            )
            try:
                payload["census"] = introspection.live_array_census(
                    census_n if census_n > 1 else DEBUGZ_DEFAULT_CENSUS)
                payload["memory"] = introspection.device_memory_stats(
                    include_unavailable=True)
                payload["kernel_build"] = kernels.build_record()
            except Exception:
                log.exception("/debugz census failed")
        if qs.get("doctor", ["0"])[0] not in ("", "0"):
            from container_engine_accelerators_tpu_torch.metrics import (
                doctor,
            )
            d = doctor.get_active()
            payload["doctor"] = (d.debugz() if d is not None
                                 else {"active": False})
        if qs.get("kv", ["0"])[0] not in ("", "0"):
            if self.kv_provider is not None:
                try:
                    payload["kv"] = self.kv_provider()
                except Exception:
                    log.exception("/debugz kv provider failed")
                    payload["kv"] = {"error": "kv provider failed"}
        if qs.get("state", ["0"])[0] not in ("", "0"):
            if self.state_provider is not None:
                try:
                    payload["state"] = self.state_provider()
                except Exception:
                    log.exception("/debugz state provider failed")
                    payload["state"] = {"error": "state provider failed"}
        return payload

    def start_background(self) -> None:
        # Every exporter port carries the flight-recorder ring
        # accounting; shared registries attach once (no-op repeat).
        try:
            attach_ring_gauges(self.registry)
        except Exception:
            log.exception("ring gauge attach failed")
        app = self._make_app()
        self._httpd = wsgiref.simple_server.make_server(
            self.host, self.port, app, handler_class=_QuietHandler)
        self.bound_port = self._httpd.server_address[1]
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name=f"{self.name}-http"),
            threading.Thread(target=self._poll_loop, daemon=True,
                             name=f"{self.name}-poll"),
        ]
        for t in self._threads:
            t.start()
        log.info("%s serving on :%d/metrics", self.name, self.bound_port)

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("%s poll failed", self.name)
            self._stop.wait(self.interval)

    def stop(self) -> None:
        """Stop serving and join both threads (bounded: the poll loop
        wakes on the event, the HTTP loop on shutdown())."""
        self._stop.set()
        if getattr(self, "_httpd", None):
            self._httpd.shutdown()
        for t in getattr(self, "_threads", []):
            t.join(timeout=10)
        if getattr(self, "_httpd", None):
            self._httpd.server_close()
