"""Profiler hooks: the JAX package's `utils/profiling.py` over
torch.profiler.

    with maybe_profile("/tmp/trace"):        # or set TPU_PROFILE_DIR
        for i, batch in enumerate(batches):
            with annotate("train/step"):
                step(batch)

`maybe_profile` captures CPU and CUDA activity with torch.profiler and
writes a Chrome trace (`trace-<pid>.json`, chrome://tracing or
Perfetto) into the directory; the environment variable keeps the JAX
package's name, TPU_PROFILE_DIR, as the port keeps TPU_REPLICA_ID and
TPU_HEALTH_CONFIG. `annotate` names a region: a record_function range in
the capture and a B/E span on the flight recorder (metrics/events.py).
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
import torch.autograd.profiler as autograd_profiler

from container_engine_accelerators_tpu_torch.metrics import events

log = logging.getLogger(__name__)

PROFILE_DIR_ENV = "TPU_PROFILE_DIR"

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def maybe_profile(log_dir: str | None = None):
    """Capture a torch.profiler trace when a directory is configured
    (argument or TPU_PROFILE_DIR); yields whether a capture runs. A
    capture does not start while another profiler is active in the
    process, and a failed start or write is logged and the wrapped work
    carries on: profiling must never kill what it wraps."""
    log_dir = log_dir or os.environ.get(PROFILE_DIR_ENV)
    if not log_dir:
        yield False
        return
    from torch.profiler import ProfilerActivity, profile

    if autograd_profiler._is_profiler_enabled:
        log.error("profiler capture into %s not started: another "
                  "profiler is active in this process; continuing "
                  "unprofiled", log_dir)
        yield False
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception:
        log.exception("profiler start (%s) failed; continuing "
                      "unprofiled", log_dir)
        yield False
        return
    log.info("profiler trace -> %s", log_dir)
    # The capture window on the flight-recorder timeline, with the
    # card's memory at both edges.
    events.instant("profile/start", "xplane", {"log_dir": log_dir})
    _snapshot_memory("profile/start")
    try:
        yield True
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
            prof.export_chrome_trace(path)
        except Exception:
            log.exception("profiler stop failed; the trace in %s may be "
                          "incomplete", log_dir)
        else:
            log.info("profiler trace written to %s", path)
        events.instant("profile/stop", "xplane")
        _snapshot_memory("profile/stop")


def _snapshot_memory(tag: str) -> None:
    """Each card's memory onto the EventBus (a no-op with the bus off or
    no card)."""
    if not events.enabled():
        return
    try:
        from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
            snapshot_memory_to_bus,
        )
        snapshot_memory_to_bus(tag)
    except Exception:
        log.debug("memory snapshot failed", exc_info=True)


class _AnnotatedSpan:
    """A record_function range (when a profiler runs) and an EventBus
    B/E pair: the same named region in the capture and on the
    flight-recorder timeline."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name, inner):
        self._name = name
        self._inner = inner

    def __enter__(self):
        events.get_bus().begin(self._name, "xplane")
        self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._inner.__exit__(*exc)
        finally:
            events.get_bus().end(self._name, "xplane")


def annotate(name: str):
    """A named region. Serving regions follow `serve/<tick>` (admit,
    prefill_chunk, decode_tick: cli/serve.py), training regions
    `train/<phase>` (data_wait, step, ckpt_save, fabric_sweep:
    training/train.py), so captures line up with the recorders'
    timelines. The range goes into a torch.profiler capture only while
    one runs (record_function costs microseconds even with none), and
    onto the EventBus only while it is enabled: with neither, the one
    shared no-op context comes back and nothing is allocated."""
    ctx = (torch.profiler.record_function(name)
           if autograd_profiler._is_profiler_enabled else _NULL)
    if not events.enabled():
        return ctx
    return _AnnotatedSpan(name, ctx)
