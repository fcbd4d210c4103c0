"""Card health checker: the port's counterpart of the JAX package's
healthcheck/health_checker.py, with the same sources, checker, critical
and non-critical behaviour and duck-typed Kubernetes client.

Health is polled from three sources:

  - LogFileErrorSource tails a JSONL error feed ({"chip", "class",
    "message"} records; cli/inject_fault.py appends to it), which carries
    the classes that cannot be provoked safely;
  - RuntimeLogScraperSource tails a raw runtime or kernel log and maps
    lines to error classes with a regex table (DEFAULT_SCRAPE_RULES: the
    text the NVIDIA stack prints, held against real failures provoked on
    the card in demo/real_fault/logs/);
  - DevfsPresenceSource reports CHIP_LOST when a /dev/nvidia<N> node
    vanishes.

A critical class turns the card's devices Unhealthy in the manager and
writes the node condition `TpuCriticalError` (the error map and the boot
ID) for external auto-repair; every class is counted and recorded as an
Event (Warning if critical, else Normal). Devices only go Healthy ->
Unhealthy here: recovery is a node repair, and a new boot ID clears the
condition.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time

from prometheus_client import CollectorRegistry, Counter, Gauge

from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    PHYSICAL_PREFIX,
    UNHEALTHY,
)

log = logging.getLogger(__name__)

NODE_CONDITION_TYPE = "TpuCriticalError"
BOOT_ID_PATH = "/proc/sys/kernel/random/boot_id"
DEFAULT_ERROR_LOG = "/var/log/tpu/errors.jsonl"
HEARTBEAT_INTERVAL = 60.0


@dataclasses.dataclass(frozen=True)
class ErrorEvent:
    chip_index: int          # -1 = whole host
    error_class: str
    message: str = ""


class _TailReader:
    """Incremental line tailer tolerating rotation/truncation: a
    shrinking size resets the offset, a trailing partial write is re-read
    on the next poll."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def read_lines(self) -> list[str]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._offset:  # rotated/truncated
            self._offset = 0
        if size == self._offset:
            return []
        lines = []
        # Binary mode: the offset counts raw bytes, so non-UTF-8 bytes in
        # a raw log cannot shift the tail position.
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            for raw in f:
                if not raw.endswith(b"\n"):
                    break  # partial write; re-read next poll
                self._offset += len(raw)
                line = raw.decode(errors="replace").strip()
                if line:
                    lines.append(line)
        return lines


class LogFileErrorSource:
    """Tail a JSONL file of {"chip": N, "class": "...", "message": "..."}
    records, tolerating rotation/truncation."""

    def __init__(self, path: str = DEFAULT_ERROR_LOG):
        self._tail = _TailReader(path)

    @property
    def path(self):
        return self._tail.path

    def poll(self) -> list[ErrorEvent]:
        events = []
        for line in self._tail.read_lines():
            try:
                rec = json.loads(line)
                events.append(ErrorEvent(
                    chip_index=int(rec.get("chip", -1)),
                    error_class=str(rec["class"]),
                    message=str(rec.get("message", ""))))
            except (ValueError, KeyError):
                log.warning("malformed error record: %r", line)
        return events


# Regex -> error class for the raw log of an NVIDIA card: the same
# classes as the JAX package's table, matched against what the NVIDIA
# stack prints. Patterns are matched case-insensitively with re.search,
# first match wins; a named group `chip` (here, or _CHIP_RE as the
# fallback) attributes the error to one card, else it counts against the
# whole host. Fleets replace the table with the runtimeLogScraper config
# block (THERMAL_TRIP and ICI_CRC_ERROR have no default text here: the
# card reports them as counters, not log lines).
DEFAULT_SCRAPE_RULES = (
    # Xid lines of the NVIDIA kernel module, "NVRM: Xid
    # (PCI:0000:18:00): <n>, ...", by NVIDIA's Xid catalogue. They name
    # a PCI address, not an index, so they count against the whole host
    # unless the line also names a card. Not provoked on the card (an
    # uncorrectable ECC error or a lost bus cannot be caused safely):
    # synthetic lines in the tests cover them. Critical by default, so
    # the numbers are matched whole.
    (r"xid\s*\([^)]*\):\s*(?:48|95)(?!\d)", "HBM_ECC_UNCORRECTABLE"),
    (r"xid\s*\([^)]*\):\s*92(?!\d)", "HBM_ECC_CORRECTABLE"),
    (r"xid\s*\([^)]*\):\s*74(?!\d)", "ICI_LINK_DOWN"),
    # Xid 79: the card left the PCI bus. CHIP_LOST, not RUNTIME_HANG:
    # the device is gone, as when a chip node vanishes, and no restart of
    # the runtime brings it back.
    (r"xid\s*\([^)]*\):\s*79(?!\d)|fallen\s+off\s+the\s+bus", "CHIP_LOST"),
    (r"xid\s*\([^)]*\):\s*119(?!\d)", "RUNTIME_HANG"),
    # Application-level exhaustion, each pinned to the text captured on
    # an H100 (demo/real_fault/logs/). Non-critical by default: an
    # application's OOM is not a node fault, but fleets want it counted
    # and surfaced as an Event.
    # PyTorch's allocator refusing device memory (hbm_oom.log).
    (r"cuda\s+out\s+of\s+memory", "HBM_OOM"),
    # The toolchain refusing a block's static shared memory
    # (smem_oom.log, ptxas). Shared memory is the card's on-chip
    # scratch, as VMEM is the TPU's: the class keeps its name.
    (r"uses\s+too\s+much\s+shared\s+data", "VMEM_OOM"),
)

# A card index after a keyword. JAX's keywords plus `gpu`, since PyTorch
# writes "GPU 0". Digits must end at a token boundary: 'device
# 0000:04:00.0' (a PCI address) or '0xdead' must not read as card 0.
_CHIP_RE = re.compile(
    r"(?:chip|core|accel|device|gpu)[ _#:]*(?P<chip>\d+)(?![\w.]|:\d)",
    re.IGNORECASE)


class RuntimeLogScraperSource:
    """Tail a raw runtime or kernel log and classify its lines with the
    regex table."""

    def __init__(self, path: str, rules=None):
        self._tail = _TailReader(path)
        self.rules = [(re.compile(pat, re.IGNORECASE), cls)
                      for pat, cls in (rules or DEFAULT_SCRAPE_RULES)]

    @property
    def path(self):
        return self._tail.path

    def poll(self) -> list[ErrorEvent]:
        events = []
        for line in self._tail.read_lines():
            for pat, cls in self.rules:
                m = pat.search(line)
                if not m:
                    continue
                chip = m.groupdict().get("chip")
                if chip is None:
                    cm = _CHIP_RE.search(line)
                    chip = cm.group("chip") if cm else None
                # A custom rule's non-numeric `chip` group must not drop
                # the whole (already consumed) batch.
                if chip is not None and not str(chip).isdigit():
                    chip = None
                events.append(ErrorEvent(
                    chip_index=int(chip) if chip is not None else -1,
                    error_class=cls,
                    message=line[:512]))
                break  # first matching rule wins
        return events


class DevfsPresenceSource:
    """CHIP_LOST when a previously seen card node disappears."""

    def __init__(self, device_info):
        self.device_info = device_info
        self._seen: set[int] = {c.index for c in device_info.discover()}
        self._reported: set[int] = set()

    def poll(self) -> list[ErrorEvent]:
        current = {c.index for c in self.device_info.discover()}
        lost = self._seen - current - self._reported
        self._reported |= lost
        self._reported -= current  # card returned: arm for re-report
        self._seen |= current
        return [ErrorEvent(chip_index=i, error_class="CHIP_LOST",
                           message=f"/dev/{PHYSICAL_PREFIX}{i} disappeared")
                for i in sorted(lost)]


class TPUHealthChecker:
    def __init__(self, manager, config, sources=None, k8s=None,
                 node_name: str | None = None,
                 poll_interval: float = 5.0,
                 boot_id_path: str = BOOT_ID_PATH,
                 error_log_path: str = DEFAULT_ERROR_LOG,
                 registry: CollectorRegistry | None = None):
        self.manager = manager
        self.config = config
        self.registry = registry or CollectorRegistry()
        self.health_events = Counter(
            "tpu_health_events",
            "Health error events observed, by error class",
            ["error_class"], registry=self.registry)
        self.health_last_event_ts = Gauge(
            "tpu_health_last_event_timestamp",
            "Unix time of the most recent health error event",
            registry=self.registry)
        if sources is not None:
            self.sources = sources
        else:
            self.sources = [
                LogFileErrorSource(error_log_path),
                DevfsPresenceSource(manager.device_info),
            ]
            if getattr(config, "runtime_log_path", ""):
                self.sources.append(RuntimeLogScraperSource(
                    config.runtime_log_path,
                    rules=getattr(config, "runtime_log_rules", None)))
        self.k8s = k8s
        self.node_name = node_name or os.environ.get("NODE_NAME", "")
        self.poll_interval = poll_interval
        self.boot_id_path = boot_id_path
        self.error_counts: dict[str, int] = {}
        # The node condition drives external auto-repair, so it is only
        # written once a CRITICAL class has been seen: an application's
        # OOM on a healthy node must never set it.
        self._critical_seen = False
        self._last_event: dict | None = None
        self._stopped = False
        self._last_heartbeat = 0.0

    # ---------- lifecycle ----------

    def stop(self):
        self._stopped = True

    def run(self):
        """Poll loop. First clears a stale node condition if the node
        rebooted since it was set."""
        self.maybe_reset_condition()
        while not self._stopped:
            self.poll_once()
            time.sleep(self.poll_interval)

    # ---------- single iteration (test entry point) ----------

    def poll_once(self):
        for source in self.sources:
            try:
                events = source.poll()
            except Exception:
                log.exception("error source %r failed", source)
                continue
            for ev in events:
                self.handle_event(ev)
        if self.k8s and self._critical_seen:
            now = time.monotonic()
            if now - self._last_heartbeat >= HEARTBEAT_INTERVAL:
                self._last_heartbeat = now
                self.update_condition()

    def handle_event(self, ev: ErrorEvent):
        log.warning("card error: chip=%d class=%s %s",
                    ev.chip_index, ev.error_class, ev.message)
        self.error_counts[ev.error_class] = (
            self.error_counts.get(ev.error_class, 0) + 1)
        self.health_events.labels(error_class=ev.error_class).inc()
        self.health_last_event_ts.set(time.time())
        critical = ev.error_class in self.config.health_critical_errors
        self._last_event = {"class": ev.error_class,
                            "chip": ev.chip_index,
                            "critical": critical,
                            "message": ev.message[:200],
                            "t": round(time.time(), 3)}
        if critical:
            self._critical_seen = True
            if ev.chip_index < 0:
                for dev_id in list(self.manager.devices):
                    self.manager.set_device_health(dev_id, UNHEALTHY)
            else:
                self.manager.set_chip_health(ev.chip_index, UNHEALTHY)
        if self.k8s:
            self.record_event(ev, critical)
            # Non-critical classes are counted and surfaced as Events
            # only; the condition needs a critical error.
            if self._critical_seen:
                self.update_condition()

    def error_summary(self) -> dict:
        """Checker state for in-process consumers: the error map the node
        condition would carry, without a cluster."""
        return {"counts": dict(self.error_counts),
                "critical_seen": self._critical_seen,
                "last_event": (dict(self._last_event)
                               if self._last_event else None)}

    # ---------- K8s surface ----------

    def boot_id(self) -> str:
        try:
            with open(self.boot_id_path) as f:
                return f.read().strip()
        except OSError:
            return "unknown"

    def record_event(self, ev: ErrorEvent, critical: bool):
        ns = "default"
        try:
            self.k8s.create_event(ns, {
                "apiVersion": "v1", "kind": "Event",
                "metadata": {
                    "generateName": "tpu-error-",
                    "namespace": ns},
                "involvedObject": {"kind": "Node", "name": self.node_name},
                "reason": ev.error_class,
                "message": (f"TPU chip {ev.chip_index}: {ev.message}"
                            if ev.chip_index >= 0 else ev.message),
                "type": "Warning" if critical else "Normal",
                "source": {"component": "tpu-device-plugin",
                           "host": self.node_name},
            })
        except Exception:
            log.exception("failed to create event")

    def _condition(self, status: str, reason: str, message: str) -> dict:
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        return {"type": NODE_CONDITION_TYPE, "status": status,
                "reason": reason, "message": message,
                "lastHeartbeatTime": now, "lastTransitionTime": now}

    def update_condition(self):
        """Condition True, its message the error-count map and the boot
        ID as JSON, for external node auto-repair."""
        payload = json.dumps({"errors": self.error_counts,
                              "bootID": self.boot_id()}, sort_keys=True)
        try:
            self.k8s.set_node_condition(
                self.node_name,
                self._condition("True", "TpuErrorsObserved", payload))
        except Exception:
            log.exception("failed to set node condition")

    def maybe_reset_condition(self, max_attempts: int = 3):
        """If the stored condition's boot ID differs from the current
        one, the node was repaired or rebooted: clear the condition."""
        if not self.k8s:
            return
        for attempt in range(max_attempts):
            try:
                node = self.k8s.get_node(self.node_name)
                conds = (node.get("status", {}) or {}).get("conditions", [])
                cond = next((c for c in conds
                             if c.get("type") == NODE_CONDITION_TYPE), None)
                if not cond or cond.get("status") != "True":
                    return
                stored = ""
                stored_errors = {}
                try:
                    payload = json.loads(cond.get("message", "{}"))
                    stored = payload.get("bootID", "")
                    stored_errors = payload.get("errors", {}) or {}
                except ValueError:
                    pass
                if stored and stored == self.boot_id():
                    # Same boot: the errors still stand. Re-arm the
                    # heartbeat, so a restarted plugin on a faulted node
                    # keeps the condition fresh, and adopt the stored
                    # counts, so the heartbeat keeps the attribution.
                    self._critical_seen = True
                    for cls, n in stored_errors.items():
                        if isinstance(n, int):
                            self.error_counts[cls] = (
                                self.error_counts.get(cls, 0) + n)
                    return
                self.k8s.set_node_condition(
                    self.node_name,
                    self._condition("False", "NodeRebooted",
                                    json.dumps({"bootID": self.boot_id()})))
                log.info("cleared %s after reboot", NODE_CONDITION_TYPE)
                return
            except Exception:
                log.exception("reset attempt %d failed", attempt)
                if attempt + 1 < max_attempts:
                    # Backoff between attempts bounds how long a dead API
                    # server stalls start-up (1 + 2 = 3 s at 3 attempts).
                    time.sleep(2 ** attempt)
