"""Port of cli/train.py's job path on the CPU: two processes of the
port's train CLI under the manifests' JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID train ONE sharded model: both
print a summary with the job's topology (2 processes, 2 devices, 1 or 2
slices) and the same final loss, plain and with --dcn-slices 2
--dcn-overlap --dcn-grad-compress int8. The --dcn-* argument errors are
the JAX CLI's, and --elastic exits naming the item it waits for."""

import json
import os
import subprocess
import sys

import pytest

from container_engine_accelerators_tpu_torch.cli import train as tcli
from container_engine_accelerators_tpu_torch.parallel import launch
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "container_engine_accelerators_tpu_torch.cli.train"
ARGS = ["--device", "cpu", "--preset", "tiny", "--steps", "3",
        "--batch-size", "4", "--seq-len", "32", "--log-every", "1"]


def _pair(extra: list, env_extra: dict | None = None) -> list[dict]:
    port = launch.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                   JAX_COORDINATOR_TIMEOUT_S="60", **(env_extra or {}))
        for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                    "MEGASCALE_NUM_SLICES", "JAX_NUM_SLICES"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", CLI, *ARGS, *extra], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("extra,slices", [
    ([], 1),
    (["--dcn-slices", "2", "--dcn-overlap", "--dcn-grad-compress", "int8"],
     2)])
def test_two_processes_train_one_model(extra, slices, two_torch_threads):
    a, b = _pair(extra)
    for s in (a, b):
        assert s["final_step"] == 3
        assert s["topology"]["processes"] == 2
        assert s["topology"]["devices"] == 2
        assert s["topology"]["slices"] == slices
        assert s["topology"]["placement"] == {"backend": "gloo",
                                              "device": "cpu"}
        # --dcn-overlap calibrates its reducer after the first step.
        assert ("dcn_attribution" in s) == (slices == 2)
    assert a["loss"] == b["loss"]


@pytest.mark.parametrize("argv,match", [
    (["--dcn-grad-compress", "int8"], "requires --dcn-overlap"),
    (["--dcn-slices", "2"], "do not split into 2 slices"),
    (["--elastic"], "training/elastic.py")])
def test_argument_errors(argv, match, monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "--steps", "1", *argv])
