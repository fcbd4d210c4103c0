"""Port of cli/serve on the CPU: the window engine behind the HTTP API
answers with the JAX package's generate tokens on weights carried across
with interop.params_from_jax."""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32)
    tcfg = tllama.llama_tiny(dtype=torch.float32)
    params = jllama.init_params(jax.random.key(0), jcfg)
    return params, jcfg, interop.params_from_jax(jax.device_get(params),
                                                 tcfg), tcfg


@pytest.fixture(params=["async", "sync"])
def server(request, weights):
    _, _, model, cfg = weights
    engine = serve.BatchingEngine(model, cfg, max_batch=4, window_ms=100.0,
                                  engine_core=request.param)
    srv = serve.make_server(engine, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://localhost:{srv.server_address[1]}", engine
    srv.shutdown()
    srv.server_close()
    engine.stop()
    engine.thread.join(timeout=10)
    assert not engine.thread.is_alive()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _jax_tokens(weights, prompt, n_new):
    params, jcfg, _, _ = weights
    return np.asarray(jdecode.generate(
        params, jnp.asarray([prompt], jnp.int32), jcfg, n_new))[0].tolist()


def test_generate_returns_jax_tokens(server, weights):
    url, engine = server
    prompts = [([1, 2, 3, 4], 5), ([9, 8, 7, 6], 5), ([42, 17], 3)]
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
        futs = [pool.submit(_post, url, {"tokens": p, "max_new_tokens": n})
                for p, n in prompts]
        answers = [f.result() for f in futs]
    for (prompt, n_new), (status, body) in zip(prompts, answers):
        assert status == 200, body
        assert json.loads(body)["tokens"] == _jax_tokens(weights, prompt,
                                                         n_new)
    # Two buckets: the two 4-token prompts share one batch.
    assert engine.requests_served == 3
    assert engine.batches_run == 2


def test_stream_events_then_done(server, weights):
    url, _ = server
    status, body = _post(url, {"tokens": [5, 6, 7], "max_new_tokens": 4,
                               "stream": True})
    assert status == 200
    events = [json.loads(line[len("data: "):])
              for line in body.split("\n\n") if line]
    want = _jax_tokens(weights, [5, 6, 7], 4)
    assert [e["token"] for e in events[:-1]] == want[3:]
    assert events[-1]["done"] and events[-1]["tokens"] == want
    assert all(e["req"] == events[0]["req"] for e in events)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)


def test_healthz_and_bad_requests(server):
    url, engine = server
    for body in ({"tokens": [], "max_new_tokens": 4},
                 {"tokens": [1], "max_new_tokens": 0},
                 {"tokens": [1, 512], "max_new_tokens": 2},
                 {"tokens": [-1], "max_new_tokens": 2},
                 {"max_new_tokens": 2}):
        status, text = _post(url, body)
        assert status == 400, (body, text)
        assert "error" in json.loads(text)
    with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
        health = json.loads(resp.read())
    # The window engine has no prefill pool: its pool fields read 0, as
    # the JAX server's do; make_server without a replica id serves
    # replica_id null, as JAX's make_server does.
    assert health == {"ok": True, "replica_id": None, "batches": 0,
                      "requests": 0,
                      "worker_alive": True, "worker_restarts": 0,
                      "prefill_workers": 0, "prefill_workers_alive": 0,
                      "prefill_worker_restarts": 0}
    assert not engine._device_busy()


def test_sampled_request_is_in_vocab(server, weights):
    url, _ = server
    status, body = _post(url, {"tokens": [3, 1], "max_new_tokens": 6,
                               "temperature": 0.9})
    assert status == 200
    toks = json.loads(body)["tokens"]
    assert toks[:2] == [3, 1] and len(toks) == 8
    assert all(0 <= t < weights[3].vocab_size for t in toks)


@pytest.mark.parametrize("flags,quantized", [
    ([], False), (["--quantize-int8"], True),
    (["--weight-dtype", "int8"], True),
    (["--quantize-int8", "--weight-dtype", "bf16"], True)])
def test_quantize_int8_is_the_weight_dtype_int8_alias(monkeypatch, flags,
                                                      quantized):
    """--quantize-int8, the JAX package's deprecated alias, serves int8
    weights as --weight-dtype int8 does (and wins over an explicit bf16,
    as in the JAX package, which sets weight_dtype from it after
    parsing)."""
    from container_engine_accelerators_tpu_torch.ops import quant

    class Served(Exception):
        pass

    calls = []

    def quantize(model):
        calls.append(model)
        return model

    def stop(*a, **k):
        raise Served

    monkeypatch.setattr(quant, "quantize_llama_params", quantize)
    monkeypatch.setattr(serve, "BatchingEngine", stop)
    with pytest.raises(Served):
        serve.main(["--tiny", "--device", "cpu", "--port", "0", *flags])
    assert len(calls) == int(quantized)
