"""chip_smoke.py's training phases (ckpt, observe_train, eval,
serve_ckpt) rehearsed on the CPU at llama_tiny size, with the card's
kernel entries counted on their plain versions, and the helpers those
phases' numbers come from (the checkpoint room, the save's step-path
cost, the wall-clock MFU)."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from tests.torch_smoke_fixtures import (  # noqa: F401
    counted_kernels,
    two_torch_threads,
)

# ---------- the training phases, rehearsed at llama_tiny size ----------

CKPT_KEYS = {"phase", "model", "n_layers", "params", "batch", "seq",
             "resume_rtol", "uninterrupted_losses", "sync", "async",
             "async_step_path_over_sync", "torn", "ckpt_dir", "launches"}
CKPT_MODE_KEYS = {"bit_identical", "max_param_rel_diff",
                  "last_loss_rel_diff", "last_loss", "steps_on_disk",
                  "step_path_s", "save_call_s", "end_join_s", "saves",
                  "bytes_per_save",
                  "save_gb_per_s", "restore", "restore_gb_per_s", "fit_s",
                  "launches"}
OBSERVE_TRAIN_KEYS = {"phase", "model", "n_layers", "batch", "seq", "steps",
                      "watchdog_threshold_s", "stall_s", "jsonl_step_lines",
                      "heartbeat", "max_train_stalled", "scrapes",
                      "scrape_mfu", "scrape_tokens_per_sec", "recorder_mfu",
                      "wall_clock_mfu", "peak_flops", "summary",
                      "launches"}
EVAL_KEYS = {"phase", "eval_loss", "perplexity", "batches", "weight_dtype",
             "loss_fn", "rel_diff", "rtol", "n_layers", "batch", "seq",
             "seconds", "launches"}
SERVE_CKPT_KEYS = {"phase", "n_layers", "prompt_len", "new_tokens", "bf16",
                   "int8", "cli_generate_equal", "launches"}


def test_training_phase_reports_hold_their_keys(counted_kernels, tmp_path,
                                                capsys, two_torch_threads):
    import numpy as np
    import torch

    cfg, dev = counted_kernels, torch.device("cpu")
    ck = chip_smoke.ckpt_phase(torch, dev, np, str(tmp_path), str(tmp_path),
                               cfg, batch=1, seq=256)
    assert set(ck) == CKPT_KEYS
    for mode in ("sync", "async"):
        assert set(ck[mode]) == CKPT_MODE_KEYS, mode
        assert ck[mode]["bit_identical"] and ck[mode]["steps_on_disk"] == [
            4, 6]
    assert ck["torn"]["steps_on_disk"] == ["4", "6", "6.corrupt"]
    assert ck["launches"]["flash_fwd"] > 0
    ob = chip_smoke.observe_train_phase(torch, dev, np, str(tmp_path), cfg,
                                        batch=1, seq=256, threshold_s=0.5,
                                        stall_s=1.5)
    assert set(ob) == OBSERVE_TRAIN_KEYS
    assert ob["heartbeat"] == ["0", "6"] and ob["max_train_stalled"] == 1.0
    assert ob["launches"]["flash_fwd"] == 6 * 2 * cfg.n_layers   # 'dots'
    ev = chip_smoke.eval_phase(torch, dev, np, ck["ckpt_dir"],
                               str(tmp_path), batch=1, seq=256)
    assert set(ev) == EVAL_KEYS and ev["rel_diff"] == 0.0
    sc = chip_smoke.serve_ckpt_phase(torch, dev, np, ck["ckpt_dir"],
                                     n_new=4)
    assert set(sc) == SERVE_CKPT_KEYS
    assert sc["bf16"]["tokens_equal_generate"]
    # The kernels line sums these phases' flash launches and serve_ckpt's
    # K1-K3: each report carries its launches.
    assert all("launches" in r for r in (ck, ob, ev, sc))
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [line["phase"] for line in lines] == [
        "ckpt", "observe_train", "eval", "serve_ckpt"]


def test_ckpt_room_sweeps_dead_roots_and_checks_shm_and_memory(
        monkeypatch, tmp_path):
    from collections import namedtuple

    usage = namedtuple("usage", "total used free")
    sizes = {}
    monkeypatch.setattr(chip_smoke.shutil, "disk_usage",
                        lambda p: usage(0, 0, sizes[p]))
    shm = tmp_path / "shm"
    shm.mkdir()
    # A root whose smoke is gone is swept; a live one (this process's)
    # and another name stay.
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    for name in (f"chip_smoke_ckpt-{dead.pid}-ab", f"chip_smoke_ckpt-"
                 f"{os.getpid()}-cd", "other"):
        (shm / name).mkdir()
    step2 = 17_842_814_976       # 1.49 B parameters x 12 bytes
    sizes.update({str(tmp_path): 10 ** 12, str(shm): 60 << 30})
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 100 << 30)
    room = chip_smoke.ckpt_room(str(tmp_path), str(shm))
    assert room["n_layers"] == 2 and room["where"] == str(shm)
    assert room["state_bytes"] == step2
    assert room["swept"] == [f"chip_smoke_ckpt-{dead.pid}-ab"]
    assert sorted(os.listdir(shm)) == [
        f"chip_smoke_ckpt-{os.getpid()}-cd", "other"]
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 50 << 30)
    with pytest.raises(chip_smoke.SmokeFailure, match="MemAvailable"):
        chip_smoke.ckpt_room(str(tmp_path), str(shm))
    monkeypatch.setattr(chip_smoke, "_mem_available_bytes",
                        lambda: 100 << 30)
    sizes[str(shm)] = 40 << 30
    with pytest.raises(chip_smoke.SmokeFailure, match="must hold"):
        chip_smoke.ckpt_room(str(tmp_path), str(shm))


def test_step_path_extra_counts_the_steps_a_save_slows():
    # The loop logs each step; a save's cost shows as the gaps and the
    # tail beyond the uninterrupted run's, wherever the save splits it.
    ref = {"logs": [f"step {i} loss 1" for i in range(1, 7)],
           "log_times": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], "end": 6.5}
    run = {"logs": ["step 1 loss 1", "step 2 loss 1", "step 3 loss 1",
                    "step 4 loss 1"],
           "log_times": [10.0, 11.5, 12.5, 16.0], "end": 18.0}
    # gaps +0.5, 0, +2.5; tail 2.0 against 0.5
    assert chip_smoke._step_path_extra(run, ref) == pytest.approx(4.5)
    resumed = {"logs": ["resumed from step 4", "step 5 loss 1",
                        "step 6 loss 1"],
               "log_times": [0.0, 3.0, 4.0], "end": 4.5}
    assert chip_smoke._step_path_extra(resumed, ref) == pytest.approx(0.0)


def test_wall_clock_mfu_skips_the_first_and_the_stalled_step():
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )

    cfg = llama_tiny()
    times = [0.0, 1.0, 2.0, 9.0, 10.0]        # step 4 stalled 6 s
    mfu = chip_smoke._wall_mfu(cfg, times, 100, 16, {4}, 1e6)
    assert mfu == pytest.approx(100 * 3 / 3.0 * cfg.train_flops_per_token(16)
                                / 1e6)
