"""Prometheus card metric server: the port's counterpart of the JAX
package's metrics/metrics.py, with its gauge families and labels, so one
dashboard reads either package (reference
pkg/gpu/nvidia/metrics/metrics.go:59-115: duty_cycle, memory_used/total,
request_*, per node and per container through PodResources
attribution). `tpu_chip` holds `nvidia<N>`, `model` the card's name;
the samples come from NVML (metrics/sampler.py).

Serves on :2112/metrics like the reference (cmd/nvidia_gpu/nvidia_gpu.go:57).
"""

from __future__ import annotations

import logging
import threading

from prometheus_client import CollectorRegistry, Gauge

from container_engine_accelerators_tpu_torch.deviceplugin import sharing
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    PHYSICAL_PREFIX,
)
from container_engine_accelerators_tpu_torch.metrics.serving import (
    ExporterBase,
)
from container_engine_accelerators_tpu_torch.utils.nvml import NvmlError

log = logging.getLogger(__name__)

CONTAINER_LABELS = ["namespace", "pod", "container", "tpu_chip", "model"]
NODE_LABELS = ["tpu_chip", "model"]


class MetricServer(ExporterBase):
    name = "metrics"

    def __init__(self, manager, sampler=None, pod_resources=None,
                 port: int = 2112, interval: float = 10.0,
                 registry: CollectorRegistry | None = None):
        from container_engine_accelerators_tpu_torch.metrics.devices import (
            PodResourcesClient,
        )
        from container_engine_accelerators_tpu_torch.metrics.sampler import (
            make_sampler,
        )
        self.manager = manager
        self.sampler = sampler or make_sampler()
        self.pod_resources = pod_resources or PodResourcesClient()
        self.port = port
        self.interval = interval
        self._stop = threading.Event()

        self.registry = registry or CollectorRegistry()
        self.duty_cycle = Gauge(
            "duty_cycle", "Card utilization percent, per container",
            CONTAINER_LABELS, registry=self.registry)
        self.memory_used = Gauge(
            "memory_used", "Card memory used bytes, per container",
            CONTAINER_LABELS, registry=self.registry)
        self.memory_total = Gauge(
            "memory_total", "Card memory total bytes, per container",
            CONTAINER_LABELS, registry=self.registry)
        self.node_duty_cycle = Gauge(
            "node_duty_cycle", "Card utilization percent, per card",
            NODE_LABELS, registry=self.registry)
        self.node_memory_used = Gauge(
            "node_memory_used", "Card memory used bytes, per card",
            NODE_LABELS, registry=self.registry)
        self.node_memory_total = Gauge(
            "node_memory_total", "Card memory total bytes, per card",
            NODE_LABELS, registry=self.registry)
        self.chip_memory_used = Gauge(
            "tpu_chip_memory_used_bytes",
            "Card memory bytes in use per card, from NVML",
            NODE_LABELS, registry=self.registry)
        self.chip_memory_total = Gauge(
            "tpu_chip_memory_total_bytes",
            "Card memory capacity bytes per card, from NVML",
            NODE_LABELS, registry=self.registry)
        # The request_* family reports the cards a container REQUESTED
        # (kubelet allocation), not what it uses.
        self.request_count = Gauge(
            "request_tpu_chips", "Cards requested by container "
            "(reference metrics.go request_* family)",
            ["namespace", "pod", "container"], registry=self.registry)
        self.request_count_legacy = Gauge(
            "request", "DEPRECATED: use request_tpu_chips",
            ["namespace", "pod", "container"], registry=self.registry)

    # ---------- metric computation ----------

    def _device_chips(self, device_id: str) -> list[int]:
        try:
            return [c.index for c in self.manager.chips_for_device(device_id)]
        except KeyError:
            # Device vanished between attribution and sampling.
            if sharing.is_virtual_id(device_id):
                device_id = sharing.virtual_to_physical(device_id)
            digits = "".join(ch for ch in device_id if ch.isdigit())
            return [int(digits)] if digits else []

    def update_once(self) -> None:
        model = self.manager.device_info.chip_generation()

        # One sample per card per cycle: NVML's sample window runs from
        # the previous call's last sample, so a second call for the
        # container view would read an empty window. A card NVML refuses
        # (GPU_IS_LOST, ...) drops out of this cycle and is cleared below:
        # its last gauges served stale would mask a lost card, and the
        # refusal must not freeze the other cards' either.
        samples = {}
        for chip in self.manager.chip_indices():
            try:
                s = self.sampler.sample(chip)
            except NvmlError as e:
                log.error("card %d not sampled: %s", chip, e)
                continue
            if s is not None:
                samples[chip] = s
        # Container-level: PodResources attribution (reference
        # devices.go:51-101), asked before the gauges are cleared, so a
        # scrape cannot fall into the round trip and see them empty.
        try:
            attributions = self.pod_resources.containers_with_devices()
        except Exception:
            log.exception("PodResources query failed")
            attributions = []

        # Clear everything each cycle so exited pods and vanished cards
        # drop out (reference metrics.go:241-253).
        for gauge in (self.node_duty_cycle, self.node_memory_used,
                      self.node_memory_total, self.chip_memory_used,
                      self.chip_memory_total, self.duty_cycle,
                      self.memory_used, self.memory_total,
                      self.request_count, self.request_count_legacy):
            gauge.clear()

        for chip, s in sorted(samples.items()):
            labels = dict(tpu_chip=f"{PHYSICAL_PREFIX}{chip}", model=model)
            self.node_duty_cycle.labels(**labels).set(s.duty_cycle_pct)
            self.node_memory_used.labels(**labels).set(s.memory_used_bytes)
            self.node_memory_total.labels(**labels).set(s.memory_total_bytes)
            self.chip_memory_used.labels(**labels).set(s.memory_used_bytes)
            self.chip_memory_total.labels(**labels).set(
                s.memory_total_bytes)

        for attr in attributions:
            chips = sorted({c for d in attr.device_ids
                            for c in self._device_chips(d)})
            who = dict(namespace=attr.namespace, pod=attr.pod,
                       container=attr.container)
            self.request_count.labels(**who).set(len(attr.device_ids))
            self.request_count_legacy.labels(**who).set(len(attr.device_ids))
            for chip in chips:
                s = samples.get(chip)
                if s is None:
                    continue
                labels = dict(**who, tpu_chip=f"{PHYSICAL_PREFIX}{chip}",
                              model=model)
                self.duty_cycle.labels(**labels).set(s.duty_cycle_pct)
                self.memory_used.labels(**labels).set(s.memory_used_bytes)
                self.memory_total.labels(**labels).set(s.memory_total_bytes)

    def poll_once(self) -> None:
        self.update_once()
