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
FORBIDDEN = ("jax", "jaxlib", "container_engine_accelerators_tpu")


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


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
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


def test_generate_cli_runs_on_the_cpu_when_asked(capsys):
    from container_engine_accelerators_tpu_torch.cli import generate

    assert generate.main(["--tiny", "--prompt-ids", "1,5,42",
                          "--max-new-tokens", "3", "--device", "cpu",
                          "--weight-dtype", "int8"]) == 0
    ids = capsys.readouterr().out.split("token ids:")[1]
    assert ids.strip().startswith("[1, 5, 42,")


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
