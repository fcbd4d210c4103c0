"""Port of the continuous and paged serving engines on the CPU: their
greedy tokens held against the JAX package's generate on a one-layer
llama_tiny in f32, with weights carried across by
interop.params_from_jax."""

import json
import threading
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

SMALL = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
TIMEOUT = 120
MIXED = [([1, 2, 3], 5), ([4, 5], 7), ([9, 8, 7, 6, 5, 4], 3),
         ([17] * 20, 6), ([2], 24), ([3, 1, 4, 1, 5, 9, 2, 6], 9)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


_REFERENCE: dict = {}


def direct(weights, tokens, n_new):
    """JAX generate's greedy tokens, computed once per request."""
    key = (tuple(tokens), n_new)
    if key not in _REFERENCE:
        params, jcfg, _, _ = weights
        out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32),
                               jcfg, n_new)
        _REFERENCE[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFERENCE[key]


def _engine(weights, kind, core="async", **kw):
    _, _, model, cfg = weights
    if kind == "paged":
        kw.setdefault("page", 16)
        return serve.PagedContinuousEngine(model, cfg, engine_core=core,
                                           **kw)
    kw.setdefault("prompt_bucket", 16)
    return serve.ContinuousEngine(model, cfg, engine_core=core, **kw)


def _run(eng, reqs):
    futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
    return [f.result(timeout=TIMEOUT) for f in futs]


def _stop(eng):
    eng.stop()
    eng.thread.join(timeout=30)
    assert not eng.thread.is_alive()


def _assert_no_leaked_page(eng):
    assert eng.pages_in_use == eng.prefix_index.pages_held()


KINDS = [("continuous", "async"), ("continuous", "sync"),
         ("paged", "async"), ("paged", "sync")]


@pytest.mark.parametrize("kind,core", KINDS)
def test_greedy_tokens_match_jax_mixed_lengths(weights, kind, core):
    # More requests than slots: slots (and pages) are reused.
    eng = _engine(weights, kind, core, max_slots=4, max_len=128,
                  max_prompt_len=64)
    try:
        got = _run(eng, MIXED)
        assert got == [direct(weights, t, n) for t, n in MIXED]
        assert eng.requests_served == len(MIXED)
        assert eng.prefills_run == len(MIXED)
        if kind == "paged":
            _assert_no_leaked_page(eng)
    finally:
        _stop(eng)


@pytest.mark.parametrize("kind,core", KINDS)
def test_chunked_prefill_interleaves_decode(weights, kind, core):
    eng = _engine(weights, kind, core, max_slots=2, max_len=128,
                  max_prompt_len=64, prefill_chunk=16)
    try:
        short = ([5, 6], 30)
        first = eng.submit(list(short[0]), short[1], 0.0)
        # A 45-token prompt, three chunks, while the short one decodes.
        long = (list(np.random.RandomState(1).randint(0, 128, size=45)), 6)
        second = eng.submit(list(long[0]), long[1], 0.0)
        assert first.result(timeout=TIMEOUT) == direct(weights, *short)
        assert second.result(timeout=TIMEOUT) == direct(weights, *long)
        chunks = eng.prefill_chunk_trace[-3:]
        assert eng.prefill_chunks_run == 4
        assert eng.prefill_tokens_run == 2 + 45
        assert chunks[0] < chunks[1] < chunks[2], eng.prefill_chunk_trace
    finally:
        _stop(eng)


def test_paged_preemption_keeps_greedy_tokens(weights):
    # 3 requests x (1 prompt page + ~3 decode pages) against 5 usable
    # pages: requests are preempted, requeued with their progress and
    # prefilled again, and still answer the direct greedy tokens.
    eng = _engine(weights, "paged", max_slots=3, max_len=64, pool_pages=6,
                  max_prompt_len=32)
    try:
        reqs = [([1, 2, 3], 40), ([7, 8], 40), ([11] * 5, 40)]
        assert _run(eng, reqs) == [direct(weights, t, n) for t, n in reqs]
        assert eng.preemptions > 0
        assert eng.requests_served == 3
        _assert_no_leaked_page(eng)
    finally:
        _stop(eng)


def test_paged_prefix_sharing_reuses_pages(weights):
    eng = _engine(weights, "paged", max_slots=4, max_len=128, pool_pages=40,
                  max_prompt_len=64)
    try:
        prompt = list(range(1, 37))               # 36 tokens: 2 full pages
        assert _run(eng, [(prompt, 4)]) == [direct(weights, prompt, 4)]
        assert eng.prefix_pages_reused == 0
        assert _run(eng, [(prompt, 7)]) == [direct(weights, prompt, 7)]
        assert eng.prefix_pages_reused == 2
        # Only the suffix of the second prompt was forwarded.
        assert eng.prefill_tokens_run == 36 + 4
        forked = prompt[:16] + [99] * 20          # same first page only
        assert _run(eng, [(forked, 5)]) == [direct(weights, forked, 5)]
        assert eng.prefix_pages_reused == 3
        _assert_no_leaked_page(eng)
    finally:
        _stop(eng)


def test_paged_pool_too_small_for_one_request_fails_it(weights):
    eng = _engine(weights, "paged", max_slots=2, max_len=64, pool_pages=3,
                  max_prompt_len=32)
    try:
        # Needs ~3 pages: it preempts itself as it grows until its
        # regrown prompt alone cannot fit, then fails.
        with pytest.raises(RuntimeError, match="raise --pool-pages"):
            eng.submit([1, 2, 3], 40, 0.0).result(timeout=TIMEOUT)
        assert _run(eng, [([4, 5], 8)]) == [direct(weights, [4, 5], 8)]
    finally:
        _stop(eng)


def test_submit_rejects_what_cannot_fit(weights):
    paged = _engine(weights, "paged", max_slots=2, max_len=128,
                    pool_pages=3, max_prompt_len=128)
    cont = _engine(weights, "continuous", max_slots=2, max_len=40,
                   prompt_bucket=32)
    try:
        with pytest.raises(ValueError, match="pool has only"):
            paged.submit([1] * 60, 2, 0.0).result(timeout=TIMEOUT)
        # 33 tokens bucket to 64 > max_len 40.
        with pytest.raises(ValueError, match="max_len"):
            cont.submit([1] * 33, 2, 0.0).result(timeout=TIMEOUT)
        assert _run(paged, [([1, 2], 3)]) == [direct(weights, [1, 2], 3)]
    finally:
        _stop(paged)
        _stop(cont)


def test_paged_max_len_rounds_to_the_page(weights):
    eng = _engine(weights, "paged", max_slots=2, max_len=100, page=48)
    try:
        assert eng.max_len == eng.max_pages * eng.page == 144
        assert eng.pool_pages == 2 * 3 // 2 + 1
    finally:
        _stop(eng)


def test_http_paged_stream_sends_first_token_before_done(weights):
    eng = _engine(weights, "paged", max_slots=2, max_len=128,
                  max_prompt_len=64)
    srv = serve.make_server(eng, 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://localhost:{srv.server_address[1]}"
    try:
        body = {"tokens": [5, 6, 7], "max_new_tokens": 12, "stream": True}
        req = urllib.request.Request(url + "/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            events = [json.loads(line[len(b"data: "):])
                      for line in resp.read().split(b"\n\n") if line]
        want = direct(weights, [5, 6, 7], 12)
        assert [e["token"] for e in events[:-1]] == want[3:]
        assert events[-1]["done"] and events[-1]["tokens"] == want
        # Tokens stream as they are fetched: the first one is stamped at
        # its prefill, well before the last of 12 ticks.
        assert events[0]["ts"] < events[-2]["ts"] <= events[-1]["ts"]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["requests"] == 1 and health["worker_alive"]
        assert health["batches"] == eng.steps_run > 0
        assert not eng._device_busy()
    finally:
        srv.shutdown()
        srv.server_close()
        _stop(eng)
