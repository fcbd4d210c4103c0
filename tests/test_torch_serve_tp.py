"""Port of cli/serve's tensor parallelism on the CPU: the three engines
over a decode_tp.TPRuntime (this process rank 0, one gloo follower
spawned once for the file) give the tokens of --tp 1, which are JAX
generate's greedy tokens (tests/test_serve_features.py:245-283 holds the
JAX package's engines so); speculation (ngram and the self-draft), int8
weights and int8/int4 KV caches run under tp; the CLI refuses at parse
time what does not run under --tp yet; `serve --tp 2` answers over HTTP,
and a killed follower fails its request and the server within 10 s."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import decode_tp
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
# f32 so tp 1 and tp 2 agree bit-tight enough for greedy parity over
# short rollouts (tests/test_serve_features.py's tp model).
SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab_size=128)
REQS = [([1, 2, 3], 5), ([4, 5], 6), ([9, 8, 7, 6, 5], 4),
        ([3, 9, 3, 9, 3, 9, 3], 6)]
KILL_WITHIN_S = 10.0


@pytest.fixture(scope="module")
def rt():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # A runtime forms its own group: a default group that an earlier
    # file's fabric monitor left in this worker process goes first.
    if dist.is_initialized():
        dist.destroy_process_group()
    runtime = decode_tp.TPRuntime(2, device="cpu", threads=2)
    yield runtime
    runtime.close()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(rt):
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(1), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg, rt.shard_model(model)


_REFERENCE: dict = {}


def direct(weights, tokens, n_new):
    """JAX generate's greedy tokens, once a request."""
    key = (tuple(tokens), n_new)
    if key not in _REFERENCE:
        params, jcfg = weights[:2]
        out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32),
                               jcfg, n_new)
        _REFERENCE[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFERENCE[key]


def _engine(kind, model, cfg, ops=None, **kw):
    if kind == "paged":
        return serve.PagedContinuousEngine(model, cfg, max_slots=2,
                                           max_len=256, page=16,
                                           pool_pages=40, ops=ops, **kw)
    if kind == "continuous":
        return serve.ContinuousEngine(model, cfg, max_slots=2, max_len=256,
                                      prompt_bucket=16, ops=ops, **kw)
    return serve.BatchingEngine(model, cfg, max_batch=2, window_ms=1.0,
                                ops=ops, **kw)


def _run(eng, reqs=REQS):
    futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
    try:
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        eng.stop()
        eng.thread.join(timeout=30)


@pytest.mark.parametrize("kind", ["window", "continuous", "paged"])
def test_tp_engine_greedy_parity(weights, rt, kind):
    """Each engine at tp 2 gives exactly the single-device tokens."""
    *_, tcfg, shard = weights
    eng = _engine(kind, shard, tcfg, ops=rt)
    snap = serve.engine_state_snapshot(eng, eng.recorder, "r0", kind)
    assert snap["tp"]["tp"] == 2 and snap["tp"]["backend"] == "gloo"
    got = _run(eng)
    assert got == [direct(weights, t, n) for t, n in REQS]


@pytest.mark.parametrize("kind,mode", [("paged", "ngram"),
                                       ("continuous", "draft")])
def test_tp_speculation_gives_the_plain_tokens(weights, rt, kind, mode):
    """The speculative tick under tp: verify, commit and (draft) the
    self-draft on the sharded weights run as group operations."""
    *_, tcfg, shard = weights
    eng = _engine(kind, shard, tcfg, ops=rt, speculate=mode, spec_k=3)
    got = _run(eng)
    assert got == [direct(weights, t, n) for t, n in REQS]
    assert eng.spec_ticks_run > 0


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_tp_quantized_kv_gives_tp1_tokens(weights, rt, kv):
    *_, model, tcfg, shard = weights
    cfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    want = _run(_engine("paged", model, cfg))
    eng = _engine("paged", shard, cfg, ops=rt)
    assert eng._cache.k_pool.dtype == torch.int8
    assert _run(eng) == want


def test_tp_int8_weights_give_tp1_tokens(weights, rt):
    *_, model, tcfg, shard = weights
    want = _run(_engine("continuous", quant.quantize_llama_params(model),
                        tcfg))
    qshard = rt.quantize(shard)
    assert isinstance(qshard.layers[0].w_down, quant.QuantWeight)
    assert _run(_engine("continuous", qshard, tcfg, ops=rt)) == want
    rt.drop_model(qshard)


@pytest.mark.parametrize("flags,match", [
    (["--tp", "2", "--supervise"], "ROADMAP item 8"),
    (["--tp", "2", "--engine", "paged", "--prefill-workers", "2"],
     "ROADMAP item 8"),
    (["--tp", "2", "--fabric-health"], "ROADMAP item 8"),
    (["--tp", "3"], "tp=3 must divide"),
    (["--tp", "2", "--moe-decode-ep"], "requires an MoE model"),
    (["--tp", "0"], "--tp must be"),
], ids=["supervise", "pools", "fabric", "indivisible", "dense_ep", "zero"])
def test_parse_time_refusals(flags, match, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--tiny", "--device", "cpu", "--port", "0", *flags])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body, timeout=60):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # A zombie has exited; only its parent's wait is missing.
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_serve_cli_tp2_answers_then_dies_with_a_killed_follower(tmp_path):
    """`serve --tp 2 --device cpu` spawns its follower, answers with
    --tp 1's tokens, and shows the group on /healthz; SIGKILL of the
    follower fails the request in flight and /healthz, and the server
    exits non-zero, all within KILL_WITHIN_S, leaving no process."""
    port = _free_port()
    err = open(tmp_path / "serve.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch"
         ".cli.serve", "--tiny", "--device", "cpu", "--tp", "2",
         "--engine", "continuous", "--max-len", "1200", "--port",
         str(port)], cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                health = _get(url + "/healthz")
                break
            except OSError:
                time.sleep(0.2)
        assert health is not None, (tmp_path / "serve.err").read_text()
        status, body = health
        assert status == 200 and body["ok"]
        assert body["tp"]["backend"] == "gloo" and body["tp"]["tp"] == 2
        follower = body["tp"]["pids"][1]
        assert _alive(follower)

        model = tllama.init_params(tllama.llama_tiny(),
                                   torch.Generator().manual_seed(0), "cpu")
        want = decode.generate(model, torch.tensor([[1, 5, 42]]),
                               model.cfg, 6)[0].tolist()
        status, ans = _post(url, {"tokens": [1, 5, 42],
                                  "max_new_tokens": 6})
        assert status == 200 and ans["tokens"] == want

        result = {}

        def long_request():
            result["answer"] = _post(url, {"tokens": [3] * 64,
                                           "max_new_tokens": 1024},
                                     timeout=30)
            result["t"] = time.monotonic()

        thread = threading.Thread(target=long_request)
        thread.start()
        time.sleep(1.0)   # the request is decoding
        t_kill = time.monotonic()
        os.kill(follower, signal.SIGKILL)
        thread.join(timeout=KILL_WITHIN_S + 5)
        assert not thread.is_alive(), "the request hung"
        status, ans = result["answer"]
        # Failed by the engine's own step (gloo's closed connection) or
        # by the runtime's watchdog, whichever comes first.
        assert status == 500 and ans["error"], ans
        assert result["t"] - t_kill < KILL_WITHIN_S
        rc = proc.wait(timeout=KILL_WITHIN_S)
        assert rc == serve.TP_LOST_EXIT_CODE
        assert time.monotonic() - t_kill < KILL_WITHIN_S
        assert not _alive(follower)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        err.close()


def test_generate_cli_tp2_keeps_each_rank_s_shard_of_a_checkpoint(
        tmp_path):
    """`generate --checkpoint DIR --tp 2`: every rank loads the export
    and keeps its shard; the tokens are --tp 1's on the same file."""
    from container_engine_accelerators_tpu_torch.models.convert import (
        load_model,
        save_hf_checkpoint,
    )

    cfg = tllama.llama_tiny()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    save_hf_checkpoint(model, cfg, str(tmp_path / "ckpt"))
    loaded, lcfg = load_model(str(tmp_path / "ckpt"), device="cpu")
    want = decode.generate(loaded, torch.tensor([[1, 5, 42]]), lcfg,
                           5)[0].tolist()
    proc = subprocess.run(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch"
         ".cli.generate", "--checkpoint", str(tmp_path / "ckpt"), "--tp",
         "2", "--device", "cpu", "--prompt-ids", "1,5,42",
         "--max-new-tokens", "5"], cwd=REPO, capture_output=True,
        text=True, timeout=TIMEOUT,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("token ids:"), proc.stdout[-2000:]
    assert json.loads(last.removeprefix("token ids:")) == want
