"""Card health monitoring: polled error sources -> devices Unhealthy,
node condition and Events; the counterpart of the JAX package's
healthcheck/."""

from container_engine_accelerators_tpu_torch.healthcheck.health_checker import (
    DEFAULT_SCRAPE_RULES,
    DevfsPresenceSource,
    ErrorEvent,
    LogFileErrorSource,
    RuntimeLogScraperSource,
    TPUHealthChecker,
)

__all__ = [
    "DEFAULT_SCRAPE_RULES",
    "DevfsPresenceSource",
    "ErrorEvent",
    "LogFileErrorSource",
    "RuntimeLogScraperSource",
    "TPUHealthChecker",
]
