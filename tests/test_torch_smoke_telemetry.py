"""chip_smoke.py's telemetry phase rehearsed on the CPU at llama_tiny
size: the collective bench and the exporter as processes on one gloo
rank, serve --fabric-health --doctor --fault-listen as a process
(--device cpu) through the fabric-slow and hbm-climb faults, train
--fabric-health under TPU_PROFILE_DIR, annotate's cost; its report keys.
The serve process's probes read a constant busBW here (a loaded test
host's timing noise is not the fault the phase checks; on the card they
are real), and the phase refuses to run without CUDA unless its sizes
name the CPU."""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

# llama_tiny and gloo; the doctor may also name slo_burn on a loaded CPU.
TELEMETRY_TINY = {
    "preset": "tiny", "backend": "gloo", "device_flags": ["--device", "cpu"],
    "bench": ["-b", "1k", "-e", "4k", "-f", "2", "-w", "1", "--iters", "2"],
    "bench_top": 4096,
    "serve": ["--engine", "paged", "--max-batch", "8", "--max-len", "256",
              "--page-size", "16", "--weight-dtype", "int8"],
    "max_batch": 8, "max_len": 256, "interval_s": 0.2, "warm_sweeps": 8,
    "slow": {"factor": 8.0, "seconds": 7.0}, "requests": 2, "new_tokens": 4,
    "ready_timeout_s": 120.0, "verdict_timeout_s": 20.0,
    "trainer": ["--preset", "tiny", "--batch-size", "2", "--seq-len", "64"],
    "train_steps": 4, "sweep_every": 2, "annotate_n": 20_000,
    "allow": ("slo_burn",), "fake_busbw": 1e9}
PHASE_KEYS = {"phase", "bench", "serve", "train", "exporter", "annotate",
              "seconds", "launches", "nvidia_smi"}
SERVE_KEYS = {"preset", "interval_s", "ready_s", "warmup_requests", "warm",
              "gauges_after_fault_s", "under_fault",
              "fabric_degraded_after_fault_s", "fabric_degraded_evidence",
              "cleared_after_window_s", "oom_precursor_after_climb_s",
              "after_requests", "ppermute_by_sweep", "incidents", "plan",
              "plan_total_gb", "peak_allocated_gb", "plan_minus_peak_gb",
              "nccl_group", "decode_step_mean_ms", "launches"}


def test_telemetry_phase_rehearses_its_report_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "nvidia_smi_line", lambda: "cpu")
    out = chip_smoke.telemetry_phase(torch, torch.device("cpu"), np,
                                     str(tmp_path), 42.0, TELEMETRY_TINY)
    assert set(out) == PHASE_KEYS
    bench = out["bench"]
    assert bench["rows"] == 3 * 5 and bench["collectives"] == sorted(
        chip_smoke.TELEMETRY_ZERO_BUS + ("ppermute",))
    assert all(p["equal"] for p in bench["plain"].values())
    serve = out["serve"]
    assert set(serve) == SERVE_KEYS
    assert serve["under_fault"]["score"] <= chip_smoke.TELEMETRY_SIZES[
        "score_max"]
    assert serve["under_fault"]["fabric"]["slow_rank"] == 0
    assert ["fabric_degraded", "dp"] in [list(i) for i in serve["incidents"]]
    assert serve["fabric_degraded_evidence"]["localization"] == \
        "axis dp: slow rank 0"
    assert serve["plan"] is None        # no capacity off the card
    train = out["train"]
    assert train["sweep_steps"] == [2, 4]
    assert all(b == e == 4 for b, e in train["ring_spans"].values())
    exporter = out["exporter"]
    assert exporter["nic_samples"] == 6 * len(exporter["interfaces"])
    assert len(exporter["probe_hook_busbw"]) == 3
    ann = out["annotate"]
    assert ann["paged_tick_ms_8_slots"] == 42.0
    assert ann["bus_on_us"] > 0 and ann["bus_off_us"] > 0


def test_telemetry_phase_refuses_to_run_without_cuda(tmp_path):
    with pytest.raises(chip_smoke.SmokeFailure, match="on the card"):
        chip_smoke.telemetry_phase(torch, torch.device("cpu"), np,
                                   str(tmp_path))
