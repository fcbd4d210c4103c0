"""Observability: the flight recorder (events), request tracing
(trace), the request recorder and its /metrics exporter
(request_metrics, serving), the train recorder, hang watchdog and their
/metrics exporter (train_metrics) and device memory introspection
(introspection)."""
