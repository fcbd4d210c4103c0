"""Per-card utilisation and memory sampling through NVML: the port's
counterpart of the JAX package's metrics/sampler.py.

The reference averages NVML's utilisation sample buffer through a cgo
shim, because go-nvml has no binding for it (reference
pkg/gpu/nvidia/metrics/util.go:17-88, nvmlDeviceGetAverageUsage). ctypes
reaches `nvmlDeviceGetSamples` directly, and NVML's own buffer does the
windowed averaging that the JAX package's libtpudev.so thread or sysfs
deltas do for a TPU: an NVIDIA card has no sysfs busy counter.

NvmlSampler's duty cycle is the mean of the utilisation samples newer
than the previous call's last one. Where the driver does not support
the utilisation sample buffer (NVML_ERROR_NOT_SUPPORTED), or holds no
sample newer than the last (NVML_ERROR_NOT_FOUND, or an empty answer),
it is NVML's utilisation over its last sample period
(`nvmlDeviceGetUtilizationRates`, what nvidia-smi's utilization.gpu
reads); `last_source` names the call that gave it. Any other refusal
raises: no sampler reads zeros in place of the card.
"""

from __future__ import annotations

import dataclasses
import logging

from container_engine_accelerators_tpu_torch.utils import nvml as nvml_mod

log = logging.getLogger(__name__)

SAMPLES = "nvmlDeviceGetSamples"
UTILIZATION_RATES = "nvmlDeviceGetUtilizationRates"


@dataclasses.dataclass(frozen=True)
class ChipSample:
    duty_cycle_pct: float      # 0-100 average over the sampling window
    memory_used_bytes: int
    memory_total_bytes: int


class NvmlSampler:
    """Sample each card by its minor number, through the NVML handle
    whose nvmlDeviceGetMinorNumber matches."""

    def __init__(self, session):
        self.nvml = session
        self._handles: dict[int, object] = {}
        self._last_ts: dict[int, int] = {}
        self._buffer_supported: dict[int, bool] = {}
        self.last_source: dict[int, str] = {}

    def _handle(self, chip: int):
        if chip not in self._handles:
            self._handles[chip] = self.nvml.handle_by_minor(chip)
        return self._handles[chip]

    def duty_cycle(self, chip: int) -> float:
        h = self._handle(chip)
        if self._buffer_supported.get(chip, True):
            try:
                samples = self.nvml.samples(
                    h, nvml_mod.GPU_UTILIZATION_SAMPLES,
                    self._last_ts.get(chip, 0))
            except nvml_mod.NvmlError as e:
                if e.code == nvml_mod.ERROR_NOT_SUPPORTED:
                    self._buffer_supported[chip] = False
                elif e.code != nvml_mod.ERROR_NOT_FOUND:
                    raise
                samples = []
            if samples:
                self._last_ts[chip] = max(ts for ts, _ in samples)
                self._source(chip, SAMPLES)
                return sum(v for _, v in samples) / len(samples)
        self._source(chip, UTILIZATION_RATES)
        return float(self.nvml.utilization_rates(h)[0])

    def _source(self, chip: int, source: str) -> None:
        if self.last_source.get(chip) != source:
            log.info("duty cycle of card %d from %s", chip, source)
        self.last_source[chip] = source

    def sample(self, chip: int) -> ChipSample | None:
        """None where no card NVML enumerates has minor `chip`; raises
        NvmlError on any other refusal."""
        try:
            h = self._handle(chip)
        except nvml_mod.NvmlError as e:
            if e.code != nvml_mod.ERROR_NOT_FOUND:
                raise
            return None
        total, _, used = self.nvml.memory_info(h)
        return ChipSample(duty_cycle_pct=self.duty_cycle(chip),
                          memory_used_bytes=used, memory_total_bytes=total)


class FakeSampler:
    def __init__(self, samples: dict[int, ChipSample]):
        self.samples = samples

    def sample(self, chip: int) -> ChipSample | None:
        return self.samples.get(chip)


def make_sampler(session=None) -> NvmlSampler:
    """An NvmlSampler over `session`, or a new NVML session. Raises
    NvmlError with NVML's text where the library cannot be loaded or
    initialised, or enumerates no card."""
    session = session if session is not None else nvml_mod.Nvml()
    if session.device_count() == 0:
        raise nvml_mod.NvmlError(nvml_mod.ERROR_NOT_FOUND, "Not Found",
                                 "NVML enumerates no card")
    return NvmlSampler(session)
