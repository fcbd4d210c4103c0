"""Serving observability: the flight recorder (events), request tracing
(trace), the request recorder and its /metrics exporter
(request_metrics, serving) and device memory introspection
(introspection)."""
