"""Rules of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package, its entry points default to CUDA and raise without it, and the
tests that need the card skip cleanly where there is none."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "container_engine_accelerators_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "container_engine_accelerators_tpu", "tools")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# Modules the scan must reach, the speculative path's, the node layer's,
# the NRI injector's, the scheduler's, the vision demos', device
# telemetry's, the mixture of experts' and tensor-parallel serving's
# among them.
REQUIRED = ("models/spec.py", "models/decode.py", "cli/serve.py",
            "cli/generate.py", "metrics/request_metrics.py",
            "metrics/train_metrics.py", "training/checkpoint.py",
            "models/convert.py", "cli/eval.py", "cli/train.py",
            "utils/nvml.py", "deviceplugin/devutil.py",
            "deviceplugin/manager.py", "deviceplugin/plugin_service.py",
            "deviceplugin/version_visibility.py",
            "deviceplugin/api/__init__.py",
            "deviceplugin/api/deviceplugin_grpc.py",
            "deviceplugin/api/deviceplugin_pb2.py", "k8s/__init__.py",
            "k8s/client.py", "metrics/podresources_pb2.py",
            "metrics/devices.py", "metrics/sampler.py", "metrics/metrics.py",
            "cli/device_plugin_main.py", "cli/partition_tpu.py",
            "cli/runtime_ready.py", "metrics/doctor.py",
            "metrics/fleet.py", "cli/fleet.py", "cli/fleetmon.py",
            "nri/__init__.py", "nri/daemon.py", "nri/injector.py",
            "nri/ttrpc.py", "nri/nri_api_pb2.py",
            "nri/ttrpc_messages_pb2.py", "scheduler/__init__.py",
            "scheduler/topology.py", "scheduler/label_nodes.py",
            "scheduler/schedule_daemon.py", "models/mnist.py",
            "models/resnet.py", "ops/collectives.py",
            "parallel/__init__.py", "parallel/distributed.py",
            "cli/collective_bench.py", "metrics/fabric.py",
            "metrics/fabric_health.py", "metrics/introspection.py",
            "utils/hbm_plan.py", "utils/profiling.py", "models/moe.py",
            "models/decode_tp.py", "parallel/mesh.py",
            "parallel/sharding.py", "parallel/spmd_util.py",
            "parallel/grad_comm.py", "parallel/ring_attention.py",
            "parallel/ulysses.py", "parallel/launch.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    assert all(PORT / name in files for name in REQUIRED)
    bad = [(f.relative_to(REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def _run(code: str, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    code = "\n".join([
        "import importlib, sys",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        f"for m in {modules!r}: importlib.import_module(m)",
        "import chip_smoke",
        "print('imported', len(sys.modules))",
    ])
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from container_engine_accelerators_tpu_torch.cli import generate, serve
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        load_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main(["--tiny", "--prompt-ids", "1,2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny", "--port", "0"])
    for flags in (["--speculate", "ngram"], ["--speculate", "draft"],
                  ["--engine", "paged", "--prefill-workers", "2",
                   "--supervise"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--tiny", "--port", "0", *flags])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main(["--tiny", "--prompt-ids", "1,2", "--speculate",
                       "ngram"])
    # Tensor parallelism places its ranks on the card unless asked for
    # the CPU, and raises before it spawns any rank.
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny", "--port", "0", "--tp", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main(["--tiny", "--prompt-ids", "1,2", "--tp", "2"])


def test_train_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from container_engine_accelerators_tpu_torch.cli import train
    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )
    from container_engine_accelerators_tpu_torch.training.train import (
        fit,
        make_optimizer,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--preset", "tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(llama_tiny(), make_optimizer(), iter([]))
    from container_engine_accelerators_tpu_torch.cli import eval as eval_cli
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_cli.main(["--data", "x.bin"])


def test_generate_cli_runs_on_the_cpu_when_asked(capsys):
    from container_engine_accelerators_tpu_torch.cli import generate

    assert generate.main(["--tiny", "--prompt-ids", "1,5,42",
                          "--max-new-tokens", "3", "--device", "cpu",
                          "--weight-dtype", "int8"]) == 0
    ids = capsys.readouterr().out.split("token ids:")[1]
    assert ids.strip().startswith("[1, 5, 42,")
    for mode in ("ngram", "draft"):
        assert generate.main(["--tiny", "--prompt-ids", "1,5,42",
                              "--max-new-tokens", "3", "--device", "cpu",
                              "--weight-dtype", "int8", "--speculate",
                              mode]) == 0
        assert capsys.readouterr().out.split("token ids:")[1] == ids
    # --tp 2 on the CPU: two gloo ranks, this process and one it spawns,
    # each with its shard of the int8 weights; the tokens are tp 1's.
    assert generate.main(["--tiny", "--prompt-ids", "1,5,42",
                          "--max-new-tokens", "3", "--device", "cpu",
                          "--weight-dtype", "int8", "--tp", "2"]) == 0
    assert capsys.readouterr().out.split("token ids:")[1] == ids


def test_chip_smoke_refuses_without_cuda_or_outside_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_device_plugin_refuses_metrics_without_nvml(tmp_path, monkeypatch,
                                                    caplog):
    """--enable-metrics on a host without NVML exits non-zero with
    NVML's own error; nothing serves zeros in its place."""
    from container_engine_accelerators_tpu_torch.cli import (
        device_plugin_main,
    )
    from container_engine_accelerators_tpu_torch.utils import nvml

    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidiactl", "nvidia0"):
        (dev / name).touch()
    (tmp_path / "dp").mkdir()
    rc = device_plugin_main.main([
        "--dev-root", str(dev), "--device-plugin-path", str(tmp_path / "dp"),
        "--config-file", str(tmp_path / "absent.json"), "--enable-metrics",
        "--metrics-port", "0", "--wait-for-devices-timeout", "1"])
    assert rc == 1
    assert "NVML Shared Library Not Found" in caplog.text
    assert not (tmp_path / "dp" / "nvidiaGPU.sock").exists()


def test_card_tests_skip_cleanly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "tests/test_torch_kernels_cuda.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:]
    summary = proc.stdout.strip().splitlines()[-1]
    assert "skipped" in summary and "passed" not in summary, summary
    assert "error" not in summary and "failed" not in summary, summary
