"""Device-plugin configuration: the port's copy of the JAX package's
deviceplugin/config.py, with the same file format, classes and checks,
so a fleet config written for the JAX plugin loads here unchanged.

  chipsPerPartition        -> chips_per_partition (subslice partitioning)
  chipSharingConfig        -> sharing strategy + max clients per chip
  healthCriticalErrors     -> health_critical_errors (error classes)
  runtimeLogScraper        -> runtime_log_path + runtime_log_rules

plus the TPU_HEALTH_CONFIG env override ("CLASS1,CLASS2") of the
critical set. The error classes keep their names on the card: each is
the GPU counterpart of the TPU fault it names (HBM is the card's device
memory, VMEM its shared memory, ICI its NVLink); see
healthcheck/health_checker.py DEFAULT_SCRAPE_RULES.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

TIME_SHARING = "time-sharing"
VALID_STRATEGIES = (TIME_SHARING,)

# Error classes the health checker counts; the subset marked critical
# turns devices Unhealthy.
KNOWN_ERROR_CLASSES = (
    "HBM_ECC_UNCORRECTABLE",
    "ICI_LINK_DOWN",
    "CHIP_LOST",
    "THERMAL_TRIP",
    "RUNTIME_HANG",
    "HBM_ECC_CORRECTABLE",
    "ICI_CRC_ERROR",
    # Application-level exhaustion: counted and surfaced, not critical.
    "HBM_OOM",
    "VMEM_OOM",
)
DEFAULT_CRITICAL = ("HBM_ECC_UNCORRECTABLE", "ICI_LINK_DOWN", "CHIP_LOST",
                    "THERMAL_TRIP")


@dataclasses.dataclass
class SharingConfig:
    strategy: str = ""
    max_shared_clients_per_chip: int = 0


@dataclasses.dataclass
class TPUConfig:
    chips_per_partition: int = 0          # 0 = no subslice partitioning
    sharing: SharingConfig = dataclasses.field(default_factory=SharingConfig)
    health_critical_errors: tuple[str, ...] = DEFAULT_CRITICAL
    # Raw runtime-log scraping ("" = disabled). Rules are (regex,
    # error_class) pairs replacing the built-in table when non-empty.
    runtime_log_path: str = ""
    runtime_log_rules: tuple[tuple[str, str], ...] = ()

    def validate(self) -> None:
        for pat, cls in self.runtime_log_rules:
            re.compile(pat)
            if cls not in KNOWN_ERROR_CLASSES:
                raise ValueError(f"unknown scrape rule class {cls!r}")
        if self.chips_per_partition < 0:
            raise ValueError("chips_per_partition must be >= 0")
        if self.chips_per_partition and self.sharing.strategy:
            raise ValueError(
                "subslice partitioning and chip sharing are mutually "
                "exclusive")
        if self.sharing.strategy:
            if self.sharing.strategy not in VALID_STRATEGIES:
                raise ValueError(
                    f"invalid sharing strategy {self.sharing.strategy!r}; "
                    f"valid: {VALID_STRATEGIES}")
            if self.sharing.max_shared_clients_per_chip < 2:
                raise ValueError(
                    "sharing requires max_shared_clients_per_chip >= 2")
        for e in self.health_critical_errors:
            if e not in KNOWN_ERROR_CLASSES:
                raise ValueError(f"unknown health error class {e!r}")


def load(path: str | None = None) -> TPUConfig:
    """Load the JSON config at `path` (absent file -> defaults), then
    apply the TPU_HEALTH_CONFIG env override ("CLASS1,CLASS2")."""
    cfg = TPUConfig()
    if path and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        sharing = raw.get("chipSharingConfig", {})
        scraper = raw.get("runtimeLogScraper", {})
        cfg = TPUConfig(
            chips_per_partition=int(raw.get("chipsPerPartition", 0)),
            sharing=SharingConfig(
                strategy=sharing.get("strategy", ""),
                max_shared_clients_per_chip=int(
                    sharing.get("maxSharedClientsPerChip", 0))),
            health_critical_errors=tuple(
                raw.get("healthCriticalErrors", DEFAULT_CRITICAL)),
            runtime_log_path=str(scraper.get("path", "")),
            runtime_log_rules=tuple(
                (str(r["pattern"]), str(r["class"]))
                for r in scraper.get("rules", [])),
        )
    env = os.environ.get("TPU_HEALTH_CONFIG")
    if env:
        cfg.health_critical_errors = tuple(
            e.strip() for e in env.split(",") if e.strip())
    cfg.validate()
    return cfg
