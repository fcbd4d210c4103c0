"""chip_smoke.py's vision phase rehearsed on the CPU: the two demo
contracts at their full step counts (MNIST > 0.9 after 200 steps, the
tiny ResNet > 0.5 after 60), the card-against-CPU logits and the
ResNet-50 training report on a two-stage, 8-wide bottleneck ResNet at
32^2 (the card-only calls stubbed); the FLOP count it reports MFU from;
and the phase's refusal to run without CUDA."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from container_engine_accelerators_tpu_torch.models import resnet
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

VISION_KEYS = {"phase", "nvidia_smi", "mnist", "resnet_tiny",
               "resnet50_card_vs_cpu", "resnet50"}
TRAIN_KEYS = {"stage_sizes", "width", "bottleneck", "num_classes", "dtype",
              "memory_format", "batch", "hw", "stage_s", "warmup_steps",
              "steps", "losses", "step_ms", "median_step_ms",
              "images_per_s", "train_flops_per_image", "mfu",
              "device_busy_ms_per_step", "device_busy_share",
              "top_kernels_ms_per_step", "max_memory_allocated_bytes",
              "running_stats_moved", "stem_running_mean_abs_max",
              "stem_running_var_mean", "eval_logits_finite"}


def test_vision_phase_rehearses_its_report_keys(monkeypatch):
    monkeypatch.setattr(chip_smoke, "nvidia_smi_line", lambda: "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = resnet.resnet50(stage_sizes=(1, 1), width=8, num_classes=10)
    out = chip_smoke.vision_phase(torch, torch.device("cpu"), np, cfg=cfg,
                                  batch=4, hw=32)
    assert set(out) == VISION_KEYS
    assert out["mnist"]["accuracy"] > chip_smoke.MNIST_MIN_ACC
    assert out["mnist"]["steps"] == 200
    assert out["resnet_tiny"]["accuracy"] > chip_smoke.RESNET_TINY_MIN_ACC
    assert out["resnet_tiny"]["steps"] == 60
    cvc = out["resnet50_card_vs_cpu"]
    assert cvc["eval"]["max_abs_diff"] == 0.0      # the CPU on both sides
    assert cvc["bf16_vs_f32_eval_rel"] < 0.1
    rn = out["resnet50"]
    assert set(rn) == TRAIN_KEYS
    assert rn["running_stats_moved"] == "18/18"
    assert len(rn["losses"]) == 12 and len(rn["step_ms"]) == 10
    assert rn["train_flops_per_image"] == 3 * chip_smoke.resnet_forward_flops(
        cfg, 32)


def test_resnet_forward_flops_counts_every_convolution():
    """The analytic count against the convolutions a forward runs, read
    from F.conv2d's own arguments and outputs, plus the fc."""
    import torch.nn.functional as F

    for cfg, hw in ((resnet.resnet50(width=16), 64),
                    (resnet.resnet18(width=8, num_classes=10), 32),
                    (resnet.resnet_tiny(), 32)):
        model = resnet.init_variables(torch.Generator().manual_seed(0),
                                      cfg, "cpu")
        seen = []
        conv2d = F.conv2d

        def counted(x, w, *a, **k):
            y = conv2d(x, w, *a, **k)
            seen.append(2 * y.numel() * w[0].numel())
            return y

        F.conv2d = counted
        try:
            with torch.no_grad():
                model(torch.zeros(1, hw, hw, 3))
        finally:
            F.conv2d = conv2d
        fc = 2 * model.fc.w.numel()
        assert chip_smoke.resnet_forward_flops(cfg, hw) == sum(seen) + fc
    # ResNet-50 at 224^2: 4.09 G multiply-adds, the published figure.
    assert chip_smoke.resnet_forward_flops(resnet.resnet50(), 224) == \
        8_178_368_512


def test_vision_phase_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    repo = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    proc = subprocess.run([sys.executable, "chip_smoke.py", "vision"],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
