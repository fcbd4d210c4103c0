"""Training-loop metrics: the port's copy of the JAX package's train
recorder, its hang watchdog and its `/metrics` exporter.

One `TrainRecorder` is driven by `training/train.py` (`train_loop` /
`fit`) at every step edge. The host loop times its phases and reports:

    data_wait -> step dispatch -> (ckpt save) -> (host sync at log
    boundaries) -> record_step

and the recorder turns those edges into Prometheus histograms
(step/data-wait/checkpoint-save/host-sync), throughput gauges
(tokens/s, analytic MFU from model FLOPs x `detect_peak_flops`), and
goodput accounting: every wall-clock second since the recorder started
is classified into

    productive   step compute (dispatch + the log-boundary fence that
                 drains the queued steps: the card works either way)
    restore      checkpoint restore + batch-stream fast-forward after a
                 resume (replayed data is not progress)
    recompile    the first step of a (re)started loop: the kernel
                 library's load and cuBLAS's first-call set-up
    checkpoint   synchronous save calls on the loop thread
    ckpt_async   the step-path stall of an asynchronous save (pinned
                 snapshot + the wait for the previous save)
    stalled      data waits, plus any wall-clock the loop never
                 accounted for (hangs, host overhead)
    reshard      a restore into another topology than the save's (a
                 checkpoint written at fsdp 2 restored at fsdp 1:
                 record_restore(resharded=True), from fit)
    detection / restart   elastic recovery (record_badput; the port has
                 no elastic path yet, so they stay 0 here)

A bucketed dp reduction's calibration (training/train.py
make_dcn_probes) is exported by record_dcn_attribution: the overlap
fraction, exposed seconds a step, busBW and wire bytes, and a counter
of exposed seconds that grows at every later step edge.

Metric family names, labels, buckets and JSONL keys are the JAX
package's, so one scraper and one trace merge read either package.

MFU needs the card's peak: `detect_peak_flops` knows the H100 SXM's
dense bf16 rate and returns None for the CPU or another card, and the
recorder then reports no MFU (the gauge stays 0, no `mfu_inst` key).

Crash safety, as in the JAX package:
  - Every step appends one JSON line to an optional metrics log,
    line-buffered, so a kill at any moment leaves a parseable
    trajectory (`read_metrics_jsonl` skips a torn tail line).
  - Each process touches a per-process heartbeat file every step;
    `HangWatchdog` exports `train_stalled` plus the straggling process
    id when a heartbeat ages past the threshold.

All methods take an optional `now` (monotonic seconds) so tests can
drive a synthetic timeline. Thread-safe: the training thread records
while the exporter's poll thread refreshes goodput and the watchdog
checks heartbeats.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time

from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

from container_engine_accelerators_tpu_torch.metrics import events
from container_engine_accelerators_tpu_torch.metrics.request_metrics import (
    percentiles,
)
from container_engine_accelerators_tpu_torch.metrics.serving import (
    ExporterBase,
)

log = logging.getLogger(__name__)

# Dense bf16 tensor-core peak by card name (NVIDIA's data sheets,
# without sparsity; chip_smoke.py's PEAK_FLOPS["bf16"]). Only the SXM
# H100 has 989 TFLOP/s: the PCIe card (756) and the NVL are not matched.
PEAK_FLOPS = {"h100 80gb hbm3": 989e12, "h100 sxm": 989e12}


def detect_peak_flops(device=None) -> float | None:
    """The dense bf16 peak of `device` (a torch.device or name; None:
    the current card), or None where it is not known (the CPU, another
    card): the recorder then reports no MFU."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for name, peak in PEAK_FLOPS.items():
        if name in kind:
            return peak
    return None


def infer_process_id() -> int | None:
    """This process's rank from the environment: torch's RANK, an
    Indexed Job's JOB_COMPLETION_INDEX, else a StatefulSet/JobSet pod
    ordinal (a hostname such as worker-3)."""
    for var in ("RANK", "JOB_COMPLETION_INDEX"):
        val = os.environ.get(var)
        if val is not None and val.isdigit():
            return int(val)
    m = re.search(r"-(\d+)$", os.environ.get("HOSTNAME", ""))
    return int(m.group(1)) if m else None


_HOST_ID: str | None = None


def host_id() -> str:
    """Stable identity of this host, stamped into heartbeat files so a
    peer knows whether the recorded pid is checkable against the local
    pid table."""
    global _HOST_ID
    if _HOST_ID is None:
        import socket

        # Heartbeat fields are space-separated; a hostname with
        # whitespace must not tear the format.
        _HOST_ID = (socket.gethostname() or "unknown-host").split()[0]
    return _HOST_ID


def proc_start_ticks(pid: int) -> int | None:
    """Kernel start time of `pid` (clock ticks since boot, field 22 of
    /proc/<pid>/stat): a recycled pid number never keeps the original
    start time. None when unreadable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # comm (field 2) may itself contain spaces and parens; the
        # numeric fields start after the LAST ')'.
        rest = data.rpartition(b")")[2].split()
        return int(rest[19])
    except (OSError, IndexError, ValueError):
        return None


def read_metrics_jsonl(path: str) -> list[dict]:
    """Parse a step-metrics JSONL log, tolerating a torn tail: every
    complete line is one record; the final line of a killed writer may
    be truncated mid-JSON and is skipped, never fatal."""
    out = []
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return out


# Step/phase times span the tiny-model CPU tests (~ms) through real
# multi-second training steps and multi-minute checkpoint writes.
_PHASE_BUCKETS = (.001, .0025, .005, .01, .025, .05, .1, .25, .5,
                  1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

GOODPUT_BUCKETS = ("productive", "restore", "reshard", "recompile",
                   "checkpoint", "ckpt_async", "stalled", "detection",
                   "restart")
SAMPLE_KINDS = ("step", "data_wait", "ckpt_save", "host_sync")


class TrainRecorder:
    """Step-edge recorder for the training loop; see the module
    docstring for the edge protocol and goodput taxonomy."""

    def __init__(self, registry: CollectorRegistry | None = None,
                 max_samples: int = 65536,
                 flops_per_token: float | None = None,
                 peak_flops_per_chip: float | None = None,
                 n_chips: int = 1,
                 log_path: str | None = None,
                 heartbeat_dir: str | None = None,
                 process_id: int | None = None,
                 now: float | None = None):
        self.registry = registry or CollectorRegistry()
        self._lock = threading.Lock()
        self._start = time.monotonic() if now is None else now
        self._buckets = {k: 0.0 for k in GOODPUT_BUCKETS}
        self._steps = 0
        self._tokens = 0
        self._tokens_productive = 0  # excludes first-step tokens
        self._last_step = 0
        self._last_step_ts: float | None = None  # monotonic, step edges
        # Gauges of record_dcn_attribution, made at its first call: a
        # registered gauge never set would read 0, "fully overlapped".
        self._dcn_gauges: dict | None = None
        self._dcn_exposed_per_step = 0.0
        self.last_dcn_attribution: dict | None = None
        self.samples = {k: collections.deque(maxlen=max_samples)
                        for k in SAMPLE_KINDS}

        self.flops_per_token = flops_per_token
        self.peak_flops_per_chip = peak_flops_per_chip
        self.n_chips = n_chips

        self._log_file = None
        self._log_path = log_path

        self._hb_path = None
        if heartbeat_dir:
            if process_id is None:
                process_id = infer_process_id() or 0
            os.makedirs(heartbeat_dir, exist_ok=True)
            self._hb_path = os.path.join(heartbeat_dir, f"hb-{process_id}")
        self.process_id = process_id or 0
        # 0 = start time unknown (no /proc): peers then treat a live
        # pid number as unverified rather than proof of this writer.
        self._start_ticks = proc_start_ticks(os.getpid()) or 0
        if self._hb_path is not None:
            # Touch at construction, not only at the first step edge: a
            # process spends its first seconds importing and building,
            # and a stale file from an earlier run must not read as a
            # straggler meanwhile.
            self._touch_heartbeat()

        reg = self.registry
        self.step_time = Histogram(
            "train_step_seconds",
            "Host time to dispatch one training step (pipelined: the "
            "device tail is drained by the log-boundary sync)",
            buckets=_PHASE_BUCKETS, registry=reg)
        self.data_wait = Histogram(
            "train_data_wait_seconds",
            "Time the loop waited on the batch iterator before a step",
            buckets=_PHASE_BUCKETS, registry=reg)
        self.ckpt_save = Histogram(
            "train_ckpt_save_seconds",
            "Loop-thread time inside a checkpoint save call",
            buckets=_PHASE_BUCKETS, registry=reg)
        self.host_sync = Histogram(
            "train_host_sync_seconds",
            "Log/checkpoint-boundary device fence time - the only "
            "per-loop host sync left after removing the per-step one",
            buckets=_PHASE_BUCKETS, registry=reg)

        self.steps_total = Counter(
            "train_steps", "Training steps completed", registry=reg)
        self.tokens_total = Counter(
            "train_tokens", "Non-padding tokens trained on", registry=reg)
        self.resumes_total = Counter(
            "train_resumes", "Checkpoint restores (resume events)",
            registry=reg)
        # The JAX package's compile tracker counts XLA recompiles here;
        # the port compiles nothing at run time, so it stays 0 (kept for
        # one scrape schema across the packages).
        self.recompiles_total = Counter(
            "train_recompiles",
            "Steady-state recompiles attributed to the loop (first-step "
            "set-up excluded)", registry=reg)

        self.last_step_g = Gauge(
            "train_last_step", "Most recently completed step number",
            registry=reg)
        self.loss_g = Gauge(
            "train_loss", "Loss at the last log boundary", registry=reg)
        self.tokens_per_sec_g = Gauge(
            "train_tokens_per_sec",
            "Tokens/s over productive time, all chips (excludes the "
            "first step)", registry=reg)
        self.mfu_g = Gauge(
            "train_mfu",
            "Analytic model FLOPs utilization in [0,1]: tokens/s x "
            "train FLOPs/token / (peak FLOPs x chips)", registry=reg)
        self.goodput_g = Gauge(
            "train_goodput_seconds",
            "Wall-clock seconds since recorder start, by class",
            ["bucket"], registry=reg)
        self.goodput_fraction_g = Gauge(
            "train_goodput_fraction",
            "productive / elapsed wall-clock", registry=reg)
        # Materialize every bucket label at init so the family scrapes
        # complete (all zeros) before the first step lands.
        self.goodput(now=self._start)

    # ---------- model wiring (enables MFU) ----------

    @property
    def model_configured(self) -> bool:
        return self.flops_per_token is not None

    def configure_model(self, flops_per_token: float,
                        peak_flops_per_chip: float | None = None,
                        n_chips: int = 1) -> None:
        with self._lock:
            self.flops_per_token = flops_per_token
            self.peak_flops_per_chip = peak_flops_per_chip
            self.n_chips = max(1, n_chips)

    def _peak(self) -> float | None:
        """Peak FLOP/s over all chips, or None (no MFU) when either the
        model or the card's peak is unknown."""
        if not self.flops_per_token or not self.peak_flops_per_chip:
            return None
        return self.peak_flops_per_chip * self.n_chips

    # ---------- step edges ----------

    def _observe(self, kind: str, hist, value: float) -> None:
        value = max(value, 0.0)
        hist.observe(value)
        self.samples[kind].append(value)

    def _append_log(self, record: dict) -> None:
        if self._log_path is None:
            return
        try:
            if self._log_file is None:
                # Line-buffered append: each record hits the OS as one
                # line, so a kill at any moment leaves every previous
                # line complete.
                self._log_file = open(self._log_path, "a", buffering=1)
            self._log_file.write(json.dumps(record) + "\n")
        except OSError:
            log.exception("step-metrics log write failed; disabling")
            self._log_path = None

    def _touch_heartbeat(self) -> None:
        if self._hb_path is None:
            return
        try:
            # tmp + os.replace: the watchdog keys on mtime, and replace
            # keeps the `pid step host start-ticks` content always whole
            # for the human debugging a stall.
            tmp = f"{self._hb_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"{os.getpid()} {self._last_step} "
                        f"{host_id()} {self._start_ticks}\n")
            os.replace(tmp, self._hb_path)
        except OSError:
            log.exception("heartbeat touch failed; disabling")
            self._hb_path = None

    def record_step(self, step: int, compute_s: float, tokens: int,
                    data_wait_s: float = 0.0, loss: float | None = None,
                    first: bool = False, now: float | None = None) -> None:
        """One completed training step. `first=True` marks the first
        step of a (re)started loop, whose time is dominated by one-time
        set-up: it lands in the `recompile` goodput bucket and is
        excluded from the throughput/MFU gauges."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._observe("step", self.step_time, compute_s)
            self._observe("data_wait", self.data_wait, data_wait_s)
            cs = max(compute_s, 0.0)
            self._buckets["recompile" if first else "productive"] += cs
            if not first and self._dcn_exposed_per_step > 0.0:
                # The calibration's exposed reduction of a steady step,
                # capped at the step's own time.
                self._dcn_gauges["exposed_total"].inc(
                    min(self._dcn_exposed_per_step, cs))
            self._buckets["stalled"] += max(data_wait_s, 0.0)
            self._steps += 1
            self._tokens += tokens
            if not first:
                self._tokens_productive += tokens
            self._last_step = step
            self._last_step_ts = now
            self.steps_total.inc()
            self.tokens_total.inc(tokens)
            self.last_step_g.set(step)
            if loss is not None:
                self.loss_g.set(loss)
            rec = {"kind": "step", "step": step, "t": round(time.time(), 3),
                   "compute_s": round(compute_s, 6),
                   "data_wait_s": round(data_wait_s, 6), "tokens": tokens}
            if first:
                rec["first"] = True
            if loss is not None:
                rec["loss"] = round(loss, 6)
            peak = self._peak()
            if peak and compute_s > 0 and not first:
                rec["mfu_inst"] = round(
                    tokens / compute_s * self.flops_per_token / peak, 6)
            self._refresh_rates()
            self._goodput_locked(now)
            self._append_log(rec)
            self._touch_heartbeat()
            # Flight-recorder phases: the step edge is known only
            # afterwards, so emit X (complete) events spanning
            # [now - dur, now] on the monotonic clock.
            if events.enabled():
                dw = max(data_wait_s, 0.0)
                args = {"step": step, "tokens": tokens}
                if first:
                    args["first"] = True
                if loss is not None:
                    args["loss"] = loss
                events.complete("train/step", now - cs, cs, "train", args)
                if dw > 0:
                    events.complete("train/data_wait", now - cs - dw, dw,
                                    "train", {"step": step})

    def record_steps(self, n: int, total_s: float, tokens: int,
                     now: float | None = None) -> None:
        """A fenced window of `n` back-to-back steps timed as one unit
        (a benchmark's estimator): observes the per-step average once
        and credits the whole window to productive time."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._observe("step", self.step_time, total_s / max(n, 1))
            self._buckets["productive"] += max(total_s, 0.0)
            self._steps += n
            self._tokens += tokens
            self._tokens_productive += tokens
            self._last_step += n
            self._last_step_ts = now
            self.steps_total.inc(n)
            self.tokens_total.inc(tokens)
            self.last_step_g.set(self._last_step)
            self._refresh_rates()
            self._goodput_locked(now)
            self._append_log({"kind": "window", "n": n,
                              "t": round(time.time(), 3),
                              "total_s": round(total_s, 6),
                              "tokens": tokens})
            self._touch_heartbeat()
            if events.enabled():
                ws = max(total_s, 0.0)
                events.complete("train/window", now - ws, ws, "train",
                                {"n": n, "tokens": tokens})

    def record_restore(self, seconds: float, step: int | None = None,
                       resharded: bool = False,
                       now: float | None = None) -> None:
        """A checkpoint restore. `resharded=True` marks a restore that
        translated topologies; its seconds land in `reshard`."""
        now = time.monotonic() if now is None else now
        with self._lock:
            bucket = "reshard" if resharded else "restore"
            self._buckets[bucket] += max(seconds, 0.0)
            self.resumes_total.inc()
            self._goodput_locked(now)
            rec = {"kind": "restore", "t": round(time.time(), 3),
                   "seconds": round(seconds, 6), "step": step}
            if resharded:
                rec["resharded"] = True
            self._append_log(rec)
            if events.enabled():
                s = max(seconds, 0.0)
                events.complete("train/restore", now - s, s, "train",
                                {"step": step, "resharded": resharded})

    def record_dcn_attribution(self, attr: dict) -> None:
        """A bucketed dp reduction's calibration (training/train.py
        make_dcn_probes): the overlap fraction, exposed seconds a step,
        the reduction's busBW and the wire bytes a step as gauges; later
        steps grow `train_dcn_exposed_seconds` by the exposed seconds.
        Charges no bucket (the probes are not training)."""
        with self._lock:
            if self._dcn_gauges is None:
                reg = self.registry
                self._dcn_gauges = {
                    "overlap_fraction": Gauge(
                        "train_dcn_overlap_fraction",
                        "Fraction of the bucketed dp gradient-reduction "
                        "time hidden under backward compute, in [0,1] "
                        "(calibration probe)", registry=reg),
                    "exposed": Gauge(
                        "train_dcn_exposed_seconds_per_step",
                        "Exposed (non-overlapped) DCN communication per "
                        "step: full-step minus compute-only probe time",
                        registry=reg),
                    "busbw": Gauge(
                        "train_dcn_busbw_bytes_per_second",
                        "Gradient-reduction bus bandwidth over the dp "
                        "axis (wire bytes / summed bucket reduce time)",
                        registry=reg),
                    "wire": Gauge(
                        "train_dcn_wire_bytes_per_step",
                        "Bytes crossing the dp axis per step after "
                        "gradient compression", registry=reg),
                    "exposed_total": Counter(
                        "train_dcn_exposed_seconds",
                        "Cumulative exposed-DCN wall clock charged at "
                        "step edges (per-step exposure x steady steps)",
                        registry=reg),
                }
            g = self._dcn_gauges
            exposed = max(float(attr.get("exposed_s_per_step", 0.0)), 0.0)
            g["overlap_fraction"].set(attr.get("overlap_fraction", 0.0))
            g["exposed"].set(exposed)
            g["busbw"].set(attr.get("busbw_bytes_per_second", 0.0))
            g["wire"].set(attr.get("wire_bytes_per_step", 0.0))
            self._dcn_exposed_per_step = exposed
            self.last_dcn_attribution = dict(attr)
            self._append_log({"kind": "dcn_attribution",
                              "t": round(time.time(), 3), **attr})
            if events.enabled():
                events.counter("train/dcn_overlap", {
                    "overlap_fraction": round(
                        float(attr.get("overlap_fraction", 0.0)), 4),
                    "exposed_ms_per_step": round(exposed * 1e3, 3)})

    def record_badput(self, bucket: str, seconds: float,
                      detail: dict | None = None,
                      now: float | None = None) -> None:
        """Charge wall-clock to a named badput bucket, with one JSONL
        record per charge so the gap is auditable offline."""
        if bucket not in GOODPUT_BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r} "
                             f"(known: {GOODPUT_BUCKETS})")
        now = time.monotonic() if now is None else now
        with self._lock:
            s = max(seconds, 0.0)
            self._buckets[bucket] += s
            self._goodput_locked(now)
            rec = {"kind": "badput", "bucket": bucket,
                   "t": round(time.time(), 3), "seconds": round(s, 6)}
            if detail:
                rec.update(detail)
            self._append_log(rec)
            if events.enabled():
                events.complete(f"train/{bucket}", now - s, s, "train",
                                detail)

    def record_fast_forward(self, seconds: float, batches: int = 0,
                            now: float | None = None) -> None:
        """Batch-stream replay after a resume: data pulled but not
        trained on - restore-class badput, not a data stall."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._buckets["restore"] += max(seconds, 0.0)
            self._goodput_locked(now)
            self._append_log({"kind": "fast_forward",
                              "t": round(time.time(), 3),
                              "seconds": round(seconds, 6),
                              "batches": batches})
            if events.enabled():
                s = max(seconds, 0.0)
                events.complete("train/fast_forward", now - s, s, "train",
                                {"batches": batches})

    def record_checkpoint_save(self, seconds: float,
                               now: float | None = None,
                               async_mode: bool = False) -> None:
        """Loop-thread time inside a checkpoint save call. With
        `async_mode=True` the seconds are the step-path stall of an
        asynchronous save (snapshot + wait for the previous one) and
        land in `ckpt_async`; synchronous saves charge `checkpoint`."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._observe("ckpt_save", self.ckpt_save, seconds)
            bucket = "ckpt_async" if async_mode else "checkpoint"
            self._buckets[bucket] += max(seconds, 0.0)
            self._goodput_locked(now)
            rec = {"kind": "ckpt_save", "t": round(time.time(), 3),
                   "seconds": round(seconds, 6)}
            if async_mode:
                rec["async"] = True
            self._append_log(rec)
            if events.enabled():
                s = max(seconds, 0.0)
                events.complete("train/ckpt_save", now - s, s, "train",
                                {"async": async_mode} if async_mode
                                else None)

    def record_host_sync(self, seconds: float) -> None:
        """Log-boundary device fence. Counted productive: the wait is
        the card draining steps whose dispatch was already timed."""
        with self._lock:
            self._observe("host_sync", self.host_sync, seconds)
            self._buckets["productive"] += max(seconds, 0.0)
            if events.enabled():
                s = max(seconds, 0.0)
                events.complete("train/host_sync", time.monotonic() - s,
                                s, "train")

    # ---------- derived rates / goodput ----------

    def _refresh_rates(self) -> None:
        productive = self._buckets["productive"]
        tps = (self._tokens_productive / productive) if productive > 0 \
            else 0.0
        self.tokens_per_sec_g.set(tps)
        if events.enabled():
            events.counter("train/tokens_per_sec",
                           {"tokens_per_sec": round(tps, 1)})
        peak = self._peak()
        if peak:
            mfu = tps * self.flops_per_token / peak
            self.mfu_g.set(mfu)
            if events.enabled():
                events.counter("train/mfu", {"mfu": round(mfu, 4)})

    def tokens_per_sec(self) -> float:
        """Productive-time throughput over all chips (the first step
        excluded from both numerator and denominator)."""
        with self._lock:
            productive = self._buckets["productive"]
            return (self._tokens_productive / productive) if productive > 0 \
                else 0.0

    def mfu(self) -> float:
        tps = self.tokens_per_sec()
        peak = self._peak()
        if not peak or tps <= 0:
            return 0.0
        return tps * self.flops_per_token / peak

    def _goodput_locked(self, now: float) -> dict:
        elapsed = max(now - self._start, 0.0)
        out = dict(self._buckets)
        # Wall-clock the loop never reported is a stall by definition:
        # a hang shows up here (and in the watchdog) instead of nowhere.
        out["stalled"] += max(0.0, elapsed - sum(out.values()))
        for bucket, secs in out.items():
            self.goodput_g.labels(bucket=bucket).set(secs)
        frac = out["productive"] / elapsed if elapsed > 0 else 0.0
        self.goodput_fraction_g.set(frac)
        if events.enabled():
            events.counter("train/goodput",
                           {k: round(v, 3) for k, v in out.items()})
            events.counter("train/goodput_fraction",
                           {"fraction": round(frac, 4)})
        out["elapsed"] = elapsed
        out["goodput_fraction"] = frac
        return out

    def goodput(self, now: float | None = None) -> dict:
        """Classify wall-clock since recorder start into the goodput
        buckets (refreshing the gauges) and return the split."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._goodput_locked(now)

    def last_step_age(self, now: float | None = None) -> float | None:
        """Seconds since the last completed step edge (None before the
        first)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._last_step_ts is None:
                return None
            return max(0.0, now - self._last_step_ts)

    # ---------- offline summaries ----------

    def pct(self, kind: str, ps=(50, 95, 99)) -> dict:
        with self._lock:
            xs = list(self.samples[kind])
        return percentiles(xs, ps)

    def pct_ms(self, kind: str, ps=(50, 95, 99)) -> dict:
        return {k: round(v * 1e3, 3)
                for k, v in self.pct(kind, ps).items() if v is not None}

    def summary(self, now: float | None = None) -> dict:
        g = self.goodput(now)
        return {
            "steps": self._steps,
            "tokens": self._tokens,
            "tokens_per_sec": round(self.tokens_per_sec(), 1),
            "mfu": round(self.mfu(), 4),
            "step_ms": self.pct_ms("step"),
            "data_wait_ms": self.pct_ms("data_wait"),
            "goodput": {k: round(v, 3) if isinstance(v, float) else v
                        for k, v in g.items()},
        }

    def close(self) -> None:
        with self._lock:
            if self._log_file is not None:
                try:
                    self._log_file.close()
                finally:
                    self._log_file = None
            if self._hb_path is not None:
                # Deregister the heartbeat on a clean shutdown: a process
                # that finished its run is not a straggler, but its
                # frozen file would age past any threshold.
                try:
                    os.remove(self._hb_path)
                except OSError:
                    pass
                self._hb_path = None


class HangWatchdog:
    """Heartbeat-file hang detector. Every training process touches
    `<dir>/hb-<process_id>` each step (TrainRecorder does this); the
    watchdog flags any heartbeat older than the threshold, exporting
    `train_stalled` (0/1) and `train_stalled_process` (the straggler
    with the oldest heartbeat; -1 while healthy), plus a per-process age
    gauge."""

    def __init__(self, heartbeat_dir: str, threshold_s: float = 300.0,
                 interval_s: float | None = None,
                 registry: CollectorRegistry | None = None,
                 on_stall=None):
        self.dir = heartbeat_dir
        self.threshold_s = threshold_s
        self.interval_s = interval_s or max(1.0, threshold_s / 4.0)
        self.registry = registry or CollectorRegistry()
        self.on_stall = on_stall
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._was_stalled = False

        self.stalled = Gauge(
            "train_stalled",
            "1 while any process heartbeat is older than the threshold",
            registry=self.registry)
        self.stalled_process = Gauge(
            "train_stalled_process",
            "Process id with the oldest overdue heartbeat; -1 healthy",
            registry=self.registry)
        self.heartbeat_age = Gauge(
            "train_heartbeat_age_seconds",
            "Age of each process's last heartbeat touch",
            ["process"], registry=self.registry)
        self.stalled_process.set(-1)

    def check(self, now: float | None = None) -> list[int]:
        """Scan the heartbeat dir once; returns straggler process ids,
        oldest heartbeat first. `now` is WALL time (file mtimes)."""
        now = time.time() if now is None else now
        ages: dict[int, float] = {}
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            names = []
        for name in names:
            if not name.startswith("hb-"):
                continue
            suffix = name[3:]
            if not suffix.isdigit():
                continue
            try:
                mtime = os.stat(os.path.join(self.dir, name)).st_mtime
            except OSError:
                continue  # racing a writer's replace
            age = max(0.0, now - mtime)
            ages[int(suffix)] = age
            self.heartbeat_age.labels(process=suffix).set(age)
        stragglers = sorted((p for p, a in ages.items()
                             if a > self.threshold_s),
                            key=lambda p: -ages[p])
        if stragglers:
            worst = stragglers[0]
            self.stalled.set(1)
            self.stalled_process.set(worst)
            if events.enabled():
                events.instant("train/stalled", "health",
                               {"process": worst,
                                "age_s": round(ages[worst], 1),
                                "overdue": len(stragglers)})
            log.warning(
                "train stalled: process %d heartbeat is %.0fs old "
                "(threshold %.0fs; %d process(es) overdue)",
                worst, ages[worst], self.threshold_s, len(stragglers))
            if self.on_stall is not None:
                self.on_stall(worst, ages[worst])
            self._was_stalled = True
        else:
            if self._was_stalled:
                log.info("train heartbeats recovered")
                if events.enabled():
                    events.instant("train/recovered", "health")
            self._was_stalled = False
            self.stalled.set(0)
            self.stalled_process.set(-1)
        return stragglers

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="train-hang-watchdog")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.check()
            except Exception:
                log.exception("hang watchdog check failed")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)


class TrainMetricsExporter(ExporterBase):
    """Serves a TrainRecorder's registry on /metrics (and /debugz). The
    recorder is push-updated by the training loop; the poll thread
    refreshes goodput (so `stalled` grows during a hang even with no
    step edges), runs the watchdog, reads the card's memory into the
    `tpu_hbm_*` gauges and drives any co-serving pollers registered on
    the shared registry."""

    name = "train-metrics"

    def __init__(self, recorder: TrainRecorder, port: int = 0,
                 host: str = "", interval: float = 5.0,
                 watchdog: HangWatchdog | None = None,
                 co_exporters=(), hbm_poller="auto"):
        self.recorder = recorder
        self.registry = recorder.registry
        self.port = port
        self.host = host
        self.interval = interval
        self.watchdog = watchdog
        self.co_exporters = list(co_exporters)
        if hbm_poller == "auto":
            from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
                HbmPoller,
            )
            try:
                hbm_poller = HbmPoller(registry=self.registry)
            except ValueError:
                hbm_poller = None  # the registry already carries them
        self.hbm_poller = hbm_poller
        self._stop = threading.Event()

    def poll_once(self) -> None:
        self.recorder.goodput()
        if self.watchdog is not None:
            self.watchdog.check()
        if self.hbm_poller is not None:
            self.hbm_poller.poll_once()
        for co in self.co_exporters:
            co.poll_once()
