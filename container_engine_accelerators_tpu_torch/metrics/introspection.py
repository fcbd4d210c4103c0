"""Device memory introspection for serving on the card: the part of the
JAX package's metrics/introspection.py that the serving engines use,
read from `torch.cuda` instead of jax.

**Memory stats.** `device_memory_stats()` gives one row per card from
`torch.cuda.mem_get_info(device)` (what the card has in use and in all)
and `torch.cuda.memory_stats(device)` (what this process's caching
allocator holds). `HbmPoller` samples them into the
`tpu_hbm_bytes_in_use / peak / limit / utilization` gauges and
`hbm/<device>` EventBus counter tracks, from an exporter's poll loop or
a thread of its own. `live_array_census()` ranks the allocator's live
blocks by size (`torch.cuda.memory_snapshot()`), served on every
exporter's `/debugz?census=1`. The names say "hbm" as the JAX
package's do, so one dashboard reads either; on this card it is the
H100's HBM3.

**OOM forensics.** `note_failure(exc, context)`, called at the serving
engines' failure points, recognises an out-of-memory error
(`torch.cuda.OutOfMemoryError`, or the message) and writes an atomic
post-mortem bundle next to the trace dump: per-device memory, the
live-block census, the kernel library's build record and the recent
event ring. `trace oom BUNDLE.json` prints one.

A host without a card (the CPU, or torch without CUDA) reports no
device, as the JAX package's does for a host without chips. Nothing here
synchronises the card: `mem_get_info` and the allocator's stats are
read without waiting for queued work. The poller names its devices
explicitly (by default the process's current card, captured where it is
built), so its thread never touches another card.

**The plan.** `set_expected_hbm(plan)` records the budget the process
was launched under (utils/hbm_plan.plan_serving or plan_training;
cli/serve.py and cli/train.py set it); every OOM bundle embeds it beside
the observed peak, and the doctor's live oom_precursor verdicts carry it
(`expected_hbm()`). `snapshot_memory_to_bus(tag)` puts one memory sample
on the EventBus (the profiler's start and stop marks use it).

Not ported: the XLA compile tracker (`CompileTracker`, `watch`,
`install`): the port compiles nothing at run time; its kernels are built
once by `kernels.build()`, whose record stands in the tracker's place.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time

import torch
from prometheus_client import CollectorRegistry, Gauge

from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.metrics import events

log = logging.getLogger(__name__)

OOM_DIR_ENV = "TPU_OOM_DIR"


def _default_devices() -> list[int]:
    """The process's current card, or none without CUDA."""
    if not torch.cuda.is_available():
        return []
    return [torch.cuda.current_device()]


def device_memory_stats(include_unavailable: bool = False,
                        devices: list[int] | None = None) -> list[dict]:
    """One row per card in `devices` (default: the current one):
    `bytes_in_use` and `bytes_limit` from mem_get_info (the card's used
    and total bytes, other processes and the CUDA context included),
    `peak_bytes_in_use` from max_memory_allocated, and the allocator's
    `allocated_bytes`, `reserved_bytes` and `num_allocs`. No rows without
    CUDA; a card whose stats cannot be read is skipped, or kept as
    `{"stats_available": False}` when `include_unavailable` is set."""
    if devices is None:
        devices = _default_devices()
    rows = []
    for i in devices:
        row = {"device": f"cuda:{i}"}
        try:
            row["kind"] = torch.cuda.get_device_name(i)
            free, total = torch.cuda.mem_get_info(i)
            stats = torch.cuda.memory_stats(i)
            peak = torch.cuda.max_memory_allocated(i)
        except Exception as e:
            log.debug("memory stats of cuda:%d unreadable (%s)", i, e)
            if include_unavailable:
                row["stats_available"] = False
                rows.append(row)
            continue
        row.update({
            "stats_available": True,
            "bytes_in_use": int(total - free),
            "peak_bytes_in_use": int(peak),
            "bytes_limit": int(total),
            "allocated_bytes": int(stats.get("allocated_bytes.all.current",
                                             0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "num_allocs": int(stats.get("allocation.all.current", 0)),
        })
        rows.append(row)
    return rows


def peak_hbm_bytes() -> int | None:
    """The largest per-card peak of this process's allocations
    (max_memory_allocated); None without a card."""
    peaks = [r["peak_bytes_in_use"] for r in device_memory_stats()]
    return max(peaks) if peaks else None


def live_array_census(top_n: int = 32) -> dict:
    """The top-N live blocks of the caching allocator by size, from
    torch.cuda.memory_snapshot(): the "what is resident" view that
    `/debugz?census=1` serves and every OOM bundle embeds. The tail
    beyond top_n is summarized, not dropped. A block carries its size,
    device, stream and address (the allocator keeps no shapes)."""
    if not torch.cuda.is_available():
        return {"available": False, "error": "no CUDA device", "rows": []}
    try:
        segments = torch.cuda.memory_snapshot()
    except Exception as e:
        return {"available": False, "error": str(e)[:200], "rows": []}
    rows = []
    for seg in segments:
        addr = seg.get("address", 0)
        for block in seg.get("blocks", ()):
            size = int(block.get("size", 0))
            if block.get("state") == "active_allocated" and size:
                rows.append({"nbytes": size, "device": seg.get("device"),
                             "stream": seg.get("stream"),
                             "address": hex(addr)})
            addr += size
    total = sum(r["nbytes"] for r in rows)
    rows.sort(key=lambda r: -r["nbytes"])
    head = rows[:max(top_n, 0)]
    return {"available": True, "n_arrays": len(rows), "total_bytes": total,
            "truncated_arrays": len(rows) - len(head),
            "truncated_bytes": total - sum(r["nbytes"] for r in head),
            "rows": head}


class HbmPoller:
    """Per-card memory telemetry into gauges and EventBus counter
    tracks, driven by an exporter's poll loop (`poll_once`) or a thread
    of its own (`start`). It reads only the cards it was given (default:
    the current card where it is built) and never synchronises; without
    a card it logs once and idles."""

    name = "hbm-poller"

    def __init__(self, registry: CollectorRegistry | None = None,
                 interval: float = 10.0, stats_fn=None,
                 devices: list[int] | None = None):
        self.registry = registry or CollectorRegistry()
        self.interval = interval
        self.devices = _default_devices() if devices is None else devices
        self._stats_fn = stats_fn or (
            lambda: device_memory_stats(devices=self.devices))
        self._warned = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        reg = self.registry
        self.bytes_in_use = Gauge(
            "tpu_hbm_bytes_in_use",
            "Device memory bytes in use, per device (torch.cuda "
            "mem_get_info: total - free)", ["device"], registry=reg)
        self.peak_bytes_in_use = Gauge(
            "tpu_hbm_peak_bytes_in_use",
            "High-water mark of this process's allocations, per device "
            "(torch.cuda max_memory_allocated)", ["device"], registry=reg)
        self.bytes_limit = Gauge(
            "tpu_hbm_bytes_limit",
            "Device memory bytes in all, per device", ["device"],
            registry=reg)
        self.utilization = Gauge(
            "tpu_hbm_utilization",
            "bytes_in_use / bytes_limit, per device", ["device"],
            registry=reg)

    def poll_once(self) -> list[dict]:
        rows = self._stats_fn()
        if not rows:
            if not self._warned:
                self._warned = True
                log.info("no CUDA device to read; HBM poller idle")
            return []
        for r in rows:
            dev = r["device"]
            used = r.get("bytes_in_use")
            peak = r.get("peak_bytes_in_use")
            limit = r.get("bytes_limit")
            if used is not None:
                self.bytes_in_use.labels(device=dev).set(used)
            if peak is not None:
                self.peak_bytes_in_use.labels(device=dev).set(peak)
            if limit:
                self.bytes_limit.labels(device=dev).set(limit)
                if used is not None:
                    self.utilization.labels(device=dev).set(used / limit)
            if events.enabled():
                vals = {k: r[k] for k in
                        ("bytes_in_use", "peak_bytes_in_use",
                         "bytes_limit") if k in r}
                if vals:
                    events.counter(f"hbm/{dev}", vals, "hbm")
        return rows

    def start(self) -> None:
        """A thread of its own, for hosts without an exporter poll
        loop."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                log.exception("HBM poll failed")
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def snapshot_memory_to_bus(tag: str = "snapshot") -> None:
    """One memory sample of each card onto the EventBus counter tracks
    (hbm/<device>), as HbmPoller writes them: the profiler's start and
    stop marks carry the memory around a capture window. Never raises."""
    if not events.enabled():
        return
    try:
        for r in device_memory_stats():
            vals = {k: r[k] for k in
                    ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
                    if k in r}
            if vals:
                events.counter(f"hbm/{r['device']}", vals, "hbm")
    except Exception:
        log.debug("memory snapshot (%s) failed", tag, exc_info=True)


# ---------- OOM forensics ----------

_EXPECTED_HBM: dict | None = None
LAST_BUNDLE_PATH: str | None = None


def set_expected_hbm(plan: dict | None) -> None:
    """Record the utils/hbm_plan budget this process was launched under;
    every OOM bundle embeds it next to the observed stats, so "the plan
    said it fits" is checkable post-mortem."""
    global _EXPECTED_HBM
    _EXPECTED_HBM = plan
    if plan:
        log.info("hbm_plan expectation: %.2f GB of %.1f GB (%s)",
                 plan.get("total_gb", 0.0), plan.get("hbm_gb", 0.0),
                 "fits" if plan.get("fits") else "DOES NOT FIT")


def expected_hbm() -> dict | None:
    """The budget recorded by set_expected_hbm, read-only: the doctor's
    oom_precursor verdicts attach it while the process is alive."""
    return _EXPECTED_HBM


def is_resource_exhausted(exc: BaseException) -> bool:
    """Out of device memory in any of its spellings: the
    torch.cuda.OutOfMemoryError class, an exception class named for
    resource exhaustion, or the message."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    name = type(exc).__name__.lower().replace("_", "")
    if "resourceexhausted" in name:
        return True
    msg = str(exc)
    return ("RESOURCE_EXHAUSTED" in msg
            or "resource exhausted" in msg.lower()
            or "out of memory" in msg.lower())


def _bundle_dir() -> str:
    d = os.environ.get(OOM_DIR_ENV)
    if d:
        return d
    # Next to the flight-recorder trace dump when one is armed, so the
    # post-mortem artifacts sit together.
    dump = getattr(events, "_DUMP_PATH", None)
    if dump:
        return os.path.dirname(dump) or "."
    return "."


def build_oom_bundle(context: str, exc: BaseException | None = None,
                     census_top: int = 32) -> dict:
    bundle = {
        "kind": "tpu_oom_forensics",
        "version": 1,
        "t": round(time.time(), 3),
        "pid": os.getpid(),
        "context": context,
        "error": None,
        "device_memory_stats": device_memory_stats(
            include_unavailable=True),
        "live_array_census": live_array_census(census_top),
        "kernel_build": kernels.build_record(),
        "recent_events": events.get_bus().debugz(256),
    }
    if exc is not None:
        bundle["error"] = {"type": type(exc).__name__,
                           "message": str(exc)[:2000]}
    observed = [r for r in bundle["device_memory_stats"]
                if r.get("stats_available")]
    comparison = None
    if _EXPECTED_HBM and observed:
        worst = max(observed, key=lambda r: r.get("bytes_in_use", 0))
        comparison = {
            "expected_total_gb": _EXPECTED_HBM.get("total_gb"),
            "expected_fits": _EXPECTED_HBM.get("fits"),
            "observed_peak_gb": round(
                worst.get("peak_bytes_in_use",
                          worst.get("bytes_in_use", 0)) / 1e9, 3),
            "observed_device": worst["device"],
        }
    bundle["hbm_plan"] = {"expected": _EXPECTED_HBM,
                          "comparison": comparison}
    return bundle


def write_oom_bundle(context: str, exc: BaseException | None = None,
                     path: str | None = None) -> str | None:
    """Atomic (tmp + os.replace) post-mortem bundle write. Never raises:
    forensics must not mask the error it documents. Returns the final
    path, or None on failure."""
    global LAST_BUNDLE_PATH
    try:
        bundle = build_oom_bundle(context, exc)
        if path is None:
            path = os.path.join(
                _bundle_dir(),
                f"oom-{os.getpid()}-{int(time.time())}.json")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(bundle, f)
        os.replace(tmp, path)
        LAST_BUNDLE_PATH = path
        census = bundle["live_array_census"]
        log.error(
            "OOM forensics bundle -> %s (%d live blocks, %.2f GB "
            "resident; read it with `trace oom %s`)", path,
            census.get("n_arrays", 0),
            census.get("total_bytes", 0) / 1e9, path)
        return path
    except Exception:
        log.exception("OOM forensics bundle write failed")
        return None


def note_failure(exc: BaseException, context: str,
                 path: str | None = None) -> str | None:
    """Call from an except block on any device-calling path: when the
    failure is out of memory, write the forensics bundle, mark the
    flight-recorder timeline and dump the ring next to it. A no-op for
    every other error. Returns the bundle path or None."""
    if not is_resource_exhausted(exc):
        return None
    out = write_oom_bundle(context, exc, path)
    if events.enabled():
        events.instant("oom", "forensics",
                       {"context": context,
                        "type": type(exc).__name__,
                        "bundle": out or "unwritable"})
    events.dump_now()  # the trace dump the bundle sits next to
    return out


@contextlib.contextmanager
def oom_forensics(context: str, path: str | None = None):
    """Wrap a device-calling step so an out-of-memory error writes the
    post-mortem bundle before the original error propagates."""
    try:
        yield
    except BaseException as e:
        note_failure(e, context, path)
        raise
