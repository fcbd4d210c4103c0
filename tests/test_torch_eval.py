"""The port's evaluate and cli/eval.py against the JAX package's, and the
CLIs that read a checkpoint: cli/train.py --ckpt-dir resumes in a second
call, and cli/serve.py / cli/generate.py --checkpoint serve what
training saved."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu.training import dataset as jdataset
from container_engine_accelerators_tpu.training import train as jtrain
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import eval as eval_cli
from container_engine_accelerators_tpu_torch.cli import (
    generate as generate_cli,
)
from container_engine_accelerators_tpu_torch.cli import train as train_cli
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import decode as tdecode
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import quant as tquant
from container_engine_accelerators_tpu_torch.training import (
    dataset as tdataset,
)
from container_engine_accelerators_tpu_torch.training import train as ttrain

REPO = Path(__file__).resolve().parents[1]
# f32 on both sides, sums in another order: the mean loss within 1e-5
# relative (the train tests' LOSS_RTOL).
LOSS_RTOL = 1e-5


def _token_file(tmp_path, vocab=512, n=4_000):
    path = str(tmp_path / "eval.bin")
    tdataset.write_token_file(
        np.random.RandomState(0).randint(0, vocab, size=n), path, vocab)
    return path


def _jax_eval(params, cfg, path, weights_int8=False):
    from container_engine_accelerators_tpu.parallel import (
        MeshAxes,
        make_mesh,
    )

    if weights_int8:
        params = jquant.dequantize_llama_params(
            jquant.quantize_llama_params(params), cfg.param_dtype)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=None)
    mesh = make_mesh(MeshAxes(fsdp=1), devices=jax.devices()[:1])
    return jtrain.evaluate(state, cfg, mesh, jdataset.token_file_batches(
        path, 2, 64, num_batches=3))


@pytest.mark.parametrize("use_flash", [False, True])
def test_evaluate_matches_jax(tmp_path, use_flash, monkeypatch):
    from container_engine_accelerators_tpu.ops import flash_attention as jfa

    monkeypatch.setattr(jfa, "flash_attention", __import__(
        "functools").partial(jfa.flash_attention, interpret=True))
    kw = dict(d_model=256, n_heads=2, n_kv_heads=1, use_flash=use_flash)
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **kw)
    tree = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    path = _token_file(tmp_path)
    want = _jax_eval(tree, jcfg, path)
    got = ttrain.evaluate(interop.params_from_jax(tree, tcfg), tcfg,
                          tdataset.token_file_batches(path, 2, 64,
                                                      num_batches=3))
    assert got["batches"] == want["batches"] == 3
    assert abs(got["eval_loss"] - want["eval_loss"]) <= LOSS_RTOL * abs(
        want["eval_loss"])
    assert got["perplexity"] == pytest.approx(want["perplexity"],
                                              rel=2 * LOSS_RTOL)


def test_evaluate_int8_round_trip_matches_jax(tmp_path):
    # The int8 quality gate: quantize, dequantize to f32, evaluate. The
    # port's quantizer is JAX's per channel, so from the same f32
    # weights the round trip gives the same weights.
    jcfg = jllama.llama_tiny(dtype=jnp.float32)
    tcfg = tllama.llama_tiny(dtype=torch.float32)
    tree = jax.device_get(jllama.init_params(jax.random.key(1), jcfg))
    path = _token_file(tmp_path)
    want = _jax_eval(tree, jcfg, path, weights_int8=True)
    model = interop.params_from_jax(tree, tcfg)
    back = tquant.dequantize_llama_params(tquant.quantize_llama_params(model))
    assert isinstance(back.layers[0].wq, torch.nn.Parameter) and \
        back.lm_head.dtype == torch.float32
    got = ttrain.evaluate(back, tcfg, tdataset.token_file_batches(
        path, 2, 64, num_batches=3))
    assert abs(got["eval_loss"] - want["eval_loss"]) <= LOSS_RTOL * abs(
        want["eval_loss"])


def _saved_run(tmp_path, steps=2):
    """A tiny training run saved by cli/train.py --ckpt-dir."""
    d = str(tmp_path / "run")
    assert train_cli.main(["--device", "cpu", "--preset", "tiny", "--steps",
                           str(steps), "--batch-size", "2", "--seq-len",
                           "32", "--ckpt-dir", d, "--save-every", "2"]) == 0
    return d


def test_eval_cli_prints_its_line_with_and_without_int8(tmp_path, capsys):
    d = _saved_run(tmp_path)
    capsys.readouterr()
    path = _token_file(tmp_path)
    lines = {}
    for wd in ("bf16", "int8"):
        assert eval_cli.main(["--checkpoint", d, "--data", path,
                              "--batch-size", "2", "--seq-len", "64",
                              "--batches", "2", "--weight-dtype", wd,
                              "--device", "cpu"]) == 0
        lines[wd] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    for wd, line in lines.items():
        assert line["weight_dtype"] == wd and line["batches"] == 2
        assert np.isfinite(line["eval_loss"])
        assert line["perplexity"] == pytest.approx(
            np.exp(line["eval_loss"]))
    model, cfg = convert.load_model(d, device="cpu")
    want = ttrain.evaluate(model, cfg, tdataset.token_file_batches(
        path, 2, 64, num_batches=2))
    assert lines["bf16"]["eval_loss"] == want["eval_loss"]
    assert lines["int8"]["eval_loss"] != want["eval_loss"]


def test_train_cli_resumes_from_its_ckpt_dir(tmp_path, capsys):
    d = _saved_run(tmp_path, steps=2)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["final_step"] == 2 and sorted(os.listdir(d)) == ["2"]
    assert train_cli.main(["--device", "cpu", "--preset", "tiny", "--steps",
                           "4", "--batch-size", "2", "--seq-len", "32",
                           "--ckpt-dir", d, "--save-every", "2",
                           "--ckpt-async"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 4 and out["steps"] == 2
    assert out["goodput"]["restore"] > 0
    assert sorted(os.listdir(d)) == ["2", "4"]
    # The same four steps in one call end on the same bits.
    full = str(tmp_path / "full")
    assert train_cli.main(["--device", "cpu", "--preset", "tiny", "--steps",
                           "4", "--batch-size", "2", "--seq-len", "32",
                           "--ckpt-dir", full, "--save-every", "4"]) == 0
    capsys.readouterr()
    a, _ = convert.load_model(d, device="cpu")
    b, _ = convert.load_model(full, device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


def test_generate_cli_reads_a_checkpoint(tmp_path, capsys):
    d = _saved_run(tmp_path)
    capsys.readouterr()
    assert generate_cli.main(["--checkpoint", d, "--prompt-ids", "1,5,42",
                              "--max-new-tokens", "4", "--device",
                              "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.split("token ids:")[1])
    model, cfg = convert.load_model(d, device="cpu")
    want = tdecode.generate(model, torch.tensor([[1, 5, 42]]), cfg, 4)
    assert got == want[0].tolist()
    with pytest.raises(SystemExit):
        generate_cli.main(["--prompt-ids", "1"])   # neither source


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_answers_from_a_checkpoint(tmp_path):
    d = _saved_run(tmp_path)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cli.serve",
         "--checkpoint", d, "--device", "cpu", "--engine", "paged",
         "--port", str(port), "--max-batch", "2", "--page-size", "16"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stderr=subprocess.PIPE, text=True)
    log, up = [], threading.Event()

    def read():
        for line in proc.stderr:
            log.append(line)
            if "(/generate, /healthz)" in line:
                up.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        assert up.wait(120), "".join(log)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": [1, 5, 42],
                             "max_new_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["tokens"]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    model, cfg = convert.load_model(d, device="cpu")
    want = tdecode.generate(model, torch.tensor([[1, 5, 42]]), cfg, 4)
    assert got == want[0].tolist()
