"""Port of the serving engines' speculative decoding on the CPU: the
window, continuous and paged engines with --speculate ngram|draft give
the tokens of the same engine with it off and the JAX package's greedy
tokens (weights carried across with interop.params_from_jax, f32, where
greedy identity holds exactly), the paged verify window is backed by
pages across a page boundary, sampled requests take the plain tick, a
failed verify resets the engine and fails its requests, and the
recorder's serve_spec_* families read what JAX's recorder reads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.metrics import (
    request_metrics as jrm,
)
from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama

# Tokens are compared exactly (f32 end to end, no logits compared here).
SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
TIMEOUT = 120
REPETITIVE = [5, 9, 7, 5, 9, 7, 5, 9, 7, 5, 9]
RANDOM = [3, 1, 4, 1, 5, 9, 2, 6]
REQUESTS = [(REPETITIVE, 16), (RANDOM, 12), ([17] * 20, 9),
            ([2, 7, 1, 8, 2, 8, 1, 8], 14)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


_REFERENCE: dict = {}


def direct(weights, tokens, n_new):
    """JAX generate's greedy tokens, once per request."""
    key = (tuple(tokens), n_new)
    if key not in _REFERENCE:
        params, jcfg, _, _ = weights
        out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32),
                               jcfg, n_new)
        _REFERENCE[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFERENCE[key]


def _engine(weights, kind, **kw):
    _, _, model, cfg = weights
    if kind == "paged":
        kw.setdefault("page", 16)
        return serve.PagedContinuousEngine(model, cfg, max_slots=4,
                                           max_len=128, **kw)
    if kind == "continuous":
        kw.setdefault("prompt_bucket", 16)
        return serve.ContinuousEngine(model, cfg, max_slots=4, max_len=128,
                                      **kw)
    return serve.BatchingEngine(model, cfg, max_batch=4, window_ms=20.0,
                                **kw)


def _run(eng, reqs, temps=None):
    temps = temps or [0.0] * len(reqs)
    futs = [eng.submit(list(t), n, temp)
            for (t, n), temp in zip(reqs, temps)]
    try:
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        eng.stop()
        eng.thread.join(timeout=30)
        assert not eng.thread.is_alive()


def _sample(rec, name):
    return rec.registry.get_sample_value(name)


CASES = [(kind, core) for kind in ("continuous", "paged")
         for core in ("async", "sync")] + [("window", "async")]


@pytest.mark.parametrize("kind,core", CASES)
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_engine_gives_the_plain_engines_tokens(weights, kind,
                                                           core, mode):
    off = _engine(weights, kind, engine_core=core)
    ref = _run(off, REQUESTS)
    assert ref == [direct(weights, t, n) for t, n in REQUESTS]
    eng = _engine(weights, kind, engine_core=core, speculate=mode,
                  spec_k=4, draft_layers=1)
    assert _run(eng, REQUESTS) == ref
    rec = eng.recorder
    verifies = _sample(rec, "serve_spec_verifies_total")
    assert verifies > 0
    assert (_sample(rec, "serve_spec_committed_tokens_total")
            >= verifies)
    if kind != "window":
        assert eng.spec_ticks_run > 0
        # A speculative tick commits at least a plain tick's token.
        assert eng.steps_run <= off.steps_run
    if kind == "paged":
        assert eng.pages_in_use == eng.prefix_index.pages_held()


@pytest.mark.parametrize("spec_k", [1, 7])
def test_spec_k_sweep_stays_identical(weights, spec_k):
    eng = _engine(weights, "paged", speculate="ngram", spec_k=spec_k)
    assert _run(eng, REQUESTS) == [direct(weights, t, n)
                                   for t, n in REQUESTS]
    assert eng.spec_ticks_run > 0


def _drive(eng, futs, check=None, limit=2000):
    """Run the engine's loop on this thread (its worker stopped), calling
    check() between the page growth and each decode tick."""
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        with eng._mu:
            eng._drain_queue()
            eng._admit_phase()
            eng._prefill_tick()
            assert eng._pre_step()
            if check is not None:
                check()
            eng._decode_tick()
    raise AssertionError("requests did not finish")


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_paged_verify_window_is_backed_across_a_page(weights, mode):
    """A slot whose length sits at page - 2 with k 4: the verify writes
    [len, len + 4], across the page boundary, so _pre_step must assign
    the next page before the tick, in rounds of one page a slot."""
    page, k = 16, 4
    eng = _engine(weights, "paged", speculate=mode, spec_k=k, page=page,
                  draft_layers=1, engine_core="sync")
    eng.stop()
    eng.thread.join(timeout=30)
    eng._stop.clear()
    prompt = (REPETITIVE * 2)[:page - 2]
    reqs = [(prompt, 20), (RANDOM + [4] * 6, 18)]
    futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
    windows = []

    def check():
        if not eng._spec_tick:
            return
        tables = eng._cache.tables.tolist()
        for i, sl in enumerate(eng._slots):
            if sl is None or sl["pending"] or sl["remaining"] <= 0:
                continue
            last = (sl["len"] + k) // page
            windows.append((sl["len"], last))
            assert len(sl["rows"]) > last
            assert tables[i][:last + 1] == sl["rows"][:last + 1]

    _drive(eng, futs, check)
    assert [f.result() for f in futs] == [direct(weights, t, n)
                                          for t, n in reqs]
    # The first speculative tick of the first request straddled a page.
    assert (page - 2, 1) in windows
    assert eng.spec_ticks_run > 0
    assert eng.pages_in_use == eng.prefix_index.pages_held()


def test_sampled_requests_take_the_plain_tick(weights):
    eng = _engine(weights, "paged", speculate="ngram", spec_k=4)
    outs = _run(eng, REQUESTS[:2], temps=[0.8, 0.8])
    assert eng.spec_ticks_run == 0 and eng.steps_run > 0
    for (t, n), out in zip(REQUESTS[:2], outs):
        assert out[:len(t)] == list(t) and len(out) == len(t) + n
        assert all(0 <= x < 128 for x in out)
    assert _sample(eng.recorder, "serve_spec_verifies_total") == 0
    # Beside a sampled request, a greedy one decodes on plain ticks and
    # keeps its greedy tokens.
    eng = _engine(weights, "continuous", speculate="draft", spec_k=4,
                  draft_layers=1, engine_core="sync")
    eng.stop()
    eng.thread.join(timeout=30)
    eng._stop.clear()
    futs = [eng.submit(list(REPETITIVE), 16, 0.0),
            eng.submit(list(RANDOM), 40, 0.9)]
    mixed = []

    def check():
        # While the sampled slot decodes, no tick speculates.
        if any(sl is not None and not sl["pending"] and sl["temp"] > 0
               for sl in eng._slots):
            mixed.append(eng._spec_tick)

    _drive(eng, futs, check)
    assert futs[0].result() == direct(weights, REPETITIVE, 16)
    assert len(mixed) >= 15 and not any(mixed)


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_failed_verify_resets_the_engine_and_fails_its_requests(weights,
                                                                 kind):
    eng = _engine(weights, kind, speculate="ngram", spec_k=4)
    calls = []

    def broken(tokens, active):
        calls.append(tokens.shape)
        raise RuntimeError("verify failed on purpose")

    eng._verify = broken
    try:
        fut = eng.submit(list(REPETITIVE), 16, 0.0)
        with pytest.raises(RuntimeError, match="on purpose"):
            fut.result(timeout=TIMEOUT)
        assert calls and calls[0][1] == 5
        assert _sample(eng.recorder, "serve_engine_resets_total") == 1
        # It never went on with the plain tick for that request, and the
        # rebuilt engine serves the next one (the ngram drafter finds
        # nothing in [1, 2, 3, 4], so it decodes on plain ticks).
        del eng._verify
        assert eng.submit([1, 2, 3, 4], 5, 0.0).result(
            timeout=TIMEOUT) == direct(weights, [1, 2, 3, 4], 5)
        if kind == "paged":
            assert eng.pages_in_use == eng.prefix_index.pages_held()
    finally:
        eng.stop()
        eng.thread.join(timeout=30)


def test_recorder_spec_families_read_what_jax_reads():
    calls = [dict(drafted=8, accepted=4, verifies=2, committed=6),
             dict(drafted=8, accepted=0, verifies=2, committed=2),
             dict(drafted=12, accepted=11, verifies=3, committed=14)]
    recs = [trm.RequestRecorder(), jrm.RequestRecorder()]
    for c in calls:
        for rec in recs:
            rec.observe_spec(**c)
    names = ["serve_spec_drafted_tokens_total",
             "serve_spec_accepted_tokens_total", "serve_spec_verifies_total",
             "serve_spec_committed_tokens_total",
             "serve_spec_acceptance_rate", "serve_spec_tokens_per_verify"]
    got = [_sample(recs[0], n) for n in names]
    assert got == [_sample(recs[1], n) for n in names]
    assert got[:4] == [28, 15, 7, 22]
    assert got[4] == pytest.approx(15 / 28)
    # Help strings and types are JAX's too, so one dashboard reads both.
    meta = [{(m.name, m.documentation, m.type) for m in rec.registry.collect()
             if m.name.startswith("serve_spec")} for rec in recs]
    assert meta[0] == meta[1] and len(meta[0]) == 6


def test_engine_spec_counters_match_its_ticks(weights):
    eng = _engine(weights, "continuous", speculate="ngram", spec_k=4)
    _run(eng, REQUESTS)
    rec = eng.recorder
    drafted = _sample(rec, "serve_spec_drafted_tokens_total")
    verifies = _sample(rec, "serve_spec_verifies_total")
    assert drafted == 4 * verifies
    assert (_sample(rec, "serve_spec_acceptance_rate")
            == pytest.approx(_sample(rec, "serve_spec_accepted_tokens_total")
                             / drafted))
    assert verifies >= eng.spec_ticks_run > 0
