"""chip_smoke.py's doctor phase rehearsed on the CPU at llama_tiny size
(in-process engines and fit counting the plain kernels, a fake card
taking the real climb, trainers and replicas as CPU processes), and the
phase's refusal to run without CUDA."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from tests.torch_smoke_fixtures import (  # noqa: F401
    FakeCard,
    counted_kernels,
    two_torch_threads,
)

DOCTOR_SCENARIOS = {"engine_hang", "worker_kill", "prefill_pool_kill",
                    "hbm_exhaustion_fabricated", "hbm_exhaustion_real",
                    "health_storm", "data_stall", "straggler",
                    "replica_kill"}
DOCTOR_KEYS = {"phase", "model", "n_layers", "fleet", "scenarios", "seconds",
               "launches", "launches_not_counted", "nvidia_smi"}
DOCTOR_RUN_KEYS = {"incidents", "window_s", "clean_warmup_s", "ring_emitted",
                   "ring_dropped", "tap_received", "tap_dropped"}
# llama_tiny sizes, and the thresholds of a CPU run on a host that other
# test workers load: the in-process doctors' hang threshold (a prefill
# worker's replacement or a slow step can leave a slot still for over a
# second there), and fleetmon's SLOs (its defaults are a card's: a TPOT
# over 0.25 s burns its budget, and CPU replicas sharing the host with
# other workers step that slowly). The card run keeps the defaults.
DOCTOR_TINY = {
    "hang_after_s": 5.0, "hang_s": 8.0,
    "fleet_slos": [
        {"name": "ttft_p99", "kind": "ttft", "threshold_s": 60.0},
        {"name": "tpot_p99", "kind": "tpot", "threshold_s": 5.0},
        {"name": "goodput", "kind": "goodput", "objective": 0.5}],
    "hang_new_tokens": 256, "kill_new_tokens": 256, "pool_new_tokens": 16,
    "fan_new_tokens": 256, "hbm_step_bytes": 4 << 30, "hbm_step_s": 0.25,
    "fit": {"batch": 1, "seq": 256, "steps": 6}, "stall_s": 2.0,
    "trainer": ["--preset", "tiny", "--batch-size", "2", "--seq-len", "32"],
    "trainer_steps": (30, 2), "watchdog_s": 3.0, "straggler_delay_s": 4.0,
    "fleet_layers": 1, "ready_timeout_s": 240.0}


def test_doctor_phase_rehearses_its_report_keys(counted_kernels, monkeypatch,
                                                tmp_path, capsys,
                                                two_torch_threads):
    """The doctor phase on the CPU at llama_tiny size: the in-process
    engines and fit count the plain kernels as launches, a fake card
    takes the real climb, the trainers and the replicas are processes on
    the CPU. Every scenario names what the card run must name."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.metrics.introspection import (  # noqa: E501
        HbmPoller,
    )
    from container_engine_accelerators_tpu_torch.models.llama import (
        init_params,
    )

    card = FakeCard()
    monkeypatch.setattr(chip_smoke, "hbm_poller", lambda reg: HbmPoller(
        registry=reg, stats_fn=card.stats, devices=[0]))
    monkeypatch.setattr(chip_smoke, "card_alloc", card.alloc)
    monkeypatch.setattr(chip_smoke, "nvidia_smi_line", lambda: "cpu")
    cfg, dev = counted_kernels, torch.device("cpu")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    res = chip_smoke.doctor_phase(torch, dev, np, str(tmp_path),
                                  model=model, cfg=cfg, sizes=DOCTOR_TINY,
                                  shm=str(tmp_path))
    assert set(res) == DOCTOR_KEYS
    sc = res["scenarios"]
    assert set(sc) == DOCTOR_SCENARIOS
    verdicts = {name: [(i["class"], i["subject"]) for i in s["incidents"]]
                for name, s in sc.items()}
    assert verdicts == {
        "engine_hang": [("engine_hang", "serve")], "worker_kill": [],
        "prefill_pool_kill": [],
        "hbm_exhaustion_fabricated": [("oom_precursor", "injected:0")],
        "hbm_exhaustion_real": [("oom_precursor", "cuda:0")],
        "health_storm": [("health_storm", "HBM_ECC_UNCORRECTABLE")],
        "data_stall": [], "straggler": [("straggler", "process-1")],
        "replica_kill": [("replica_down", "r1")]}
    for name in DOCTOR_SCENARIOS - {"straggler", "replica_kill"}:
        assert DOCTOR_RUN_KEYS <= set(sc[name]), name
    real = sc["hbm_exhaustion_real"]
    assert real["projected_tte_s"] > 0 and real["actual_tte_s"] > 0
    assert card.used == 20 << 30                     # the climb freed
    assert sc["replica_kill"]["replayed"] == [
        {"class": "replica_down", "subject": "r1"}]
    assert sc["replica_kill"]["fleet_slos"] == DOCTOR_TINY["fleet_slos"]
    assert set(sc["replica_kill"]["warmup_tpot_ms"]) == {"r0", "r1"}
    assert sc["engine_hang"]["hang_after_s"] == DOCTOR_TINY["hang_after_s"]
    assert sc["data_stall"]["stall_step_data_wait_s"] >= 2.0
    assert all(res["launches"].get(k, 0) > 0 for k in (
        "decode_attention", "paged_decode_attention", "flash_fwd",
        "flash_bwd_dq", "flash_bwd_dkv"))
    summary = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"phase": "doctor_summary"')]
    assert set(summary[0]) - {"phase"} == DOCTOR_SCENARIOS
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith(chip_smoke.CKPT_ROOT_PREFIX)]


def test_doctor_phase_refuses_to_run_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    proc = subprocess.run([sys.executable, "chip_smoke.py", "doctor"],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_card_run_keeps_fleetmons_default_slos_and_hang_threshold():
    """The card's sizes carry no SLOs of their own: fleetmon's doctor
    runs on the defaults (the JAX package's), and the in-process
    doctors on the 2 s hang threshold."""
    from container_engine_accelerators_tpu_torch.metrics import doctor

    assert "fleet_slos" not in chip_smoke.DOCTOR_SIZES
    assert chip_smoke.DOCTOR_SIZES["hang_after_s"] == 2.0
    assert [(s.name, s.threshold_s) for s in doctor.default_slos()] == [
        ("ttft_p99", 2.0), ("tpot_p99", 0.25), ("goodput", None)]
