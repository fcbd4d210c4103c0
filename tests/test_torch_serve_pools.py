"""Port of the prefill-worker pools (serve --prefill-workers) on the CPU:
PrefillBudget grants equal the JAX package's over one sequence of notes;
pooled paged engines give JAX's greedy tokens (f32 weights carried across
with interop.params_from_jax; tokens compared exactly) in two admission
orders; decode advances between a long prompt's chunks; the page
refcounts drain to the prefix cache only; and a killed prefill worker
fails no request and counts one restart."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.cli import serve as jserve
from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.models import llama as tllama

SMALL = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
TIMEOUT = 120
PREFIX = list(range(1, 33))          # two full 16-token pages


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


_REFERENCE: dict = {}


def direct(weights, tokens, n_new):
    key = (tuple(tokens), n_new)
    if key not in _REFERENCE:
        params, jcfg, _, _ = weights
        out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32),
                               jcfg, n_new)
        _REFERENCE[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFERENCE[key]


def pooled(weights, **kw):
    _, _, model, cfg = weights
    defaults = dict(max_slots=4, max_len=256, page=16, pool_pages=40,
                    max_prompt_len=128, prefill_chunk=32,
                    prefill_workers=2)
    defaults.update(kw)
    return serve.PagedContinuousEngine(model, cfg, **defaults)


def stop(eng):
    eng.stop()
    eng.thread.join(timeout=30)
    for t in eng._prefill_threads:
        t.join(timeout=30)
    assert not eng.thread.is_alive() and eng.prefill_workers_alive() == 0


def wait_until(cond, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---------- PrefillBudget ----------

def _budgets(bucket, chunk, slack=0.5):
    return (serve.PrefillBudget(bucket, chunk, slack_frac=slack),
            jserve.PrefillBudget(bucket, chunk, slack_frac=slack))


def test_budget_grants_equal_jax_over_one_sequence_of_notes():
    rs = np.random.RandomState(0)
    for bucket, chunk, slack in ((32, 256, 0.5), (16, 0, 0.5),
                                 (128, 512, 0.25), (64, 64, 1.0)):
        port, ref = _budgets(bucket, chunk, slack)
        grants = []
        for _ in range(300):
            op = rs.randint(3)
            if op == 0:
                s = float(rs.uniform(1e-4, 0.1))
                port.note_decode(s)
                ref.note_decode(s)
            elif op == 1:
                n, s = int(rs.randint(0, 2048)), float(rs.uniform(0, 0.5))
                port.note_prefill(n, s)
                ref.note_prefill(n, s)
            for decoding in (True, False):
                grants.append((port.grant(decoding), ref.grant(decoding)))
        assert all(a == b for a, b in grants), (bucket, chunk)
        assert len({a for a, _ in grants}) > 1 or chunk == bucket


def test_budget_edge_cases_match_jax():
    # The JAX package's own cases: the whole chunk when idle, the bucket
    # floor, the slack-sized grant aligned down, the chunk cap.
    port, ref = _budgets(32, 256)
    assert port.grant(False) == ref.grant(False) == 256
    assert port.grant(True) == ref.grant(True) == 32
    assert (serve.PrefillBudget(32, 0).grant(False)
            == jserve.PrefillBudget(32, 0).grant(False) == 1 << 30)
    for notes, want in ((((0.001,), (100, 0.010)), 32),
                        (((0.0200,), (1000, 0.100)), 96),
                        (((1.0,), (1000, 0.001)), 256)):
        port, ref = _budgets(32, 256)
        for b in (port, ref):
            b.note_decode(*notes[0])
            b.note_prefill(*notes[1])
        assert port.grant(True) == ref.grant(True) == want


# ---------- the pools ----------

def test_pools_give_the_single_loops_tokens_in_two_orders(weights):
    reqs = [(PREFIX + [40 + k] * (3 + k), 5 + k) for k in range(4)]
    for ordering in (reqs, list(reversed(reqs))):
        eng = pooled(weights)
        try:
            futs = [eng.submit(list(t), n, 0.0) for t, n in ordering]
            got = [f.result(timeout=TIMEOUT) for f in futs]
            assert eng.engine_core == "sync"
            assert eng.prefill_workers_alive() == 2
        finally:
            stop(eng)
        assert got == [direct(weights, t, n) for t, n in ordering]
    # The single loop on the same requests, for the record.
    eng = pooled(weights, prefill_workers=0)
    try:
        futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
        assert [f.result(timeout=TIMEOUT) for f in futs] == [
            direct(weights, t, n) for t, n in reqs]
    finally:
        stop(eng)


def test_pools_speculate_and_record_pool_depths(weights):
    eng = pooled(weights, speculate="ngram", spec_k=4)
    reqs = [([5, 9, 7] * 6, 12), (PREFIX + [3, 1, 4], 10)]
    try:
        futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
        assert [f.result(timeout=TIMEOUT) for f in futs] == [
            direct(weights, t, n) for t, n in reqs]
        assert eng.spec_ticks_run > 0
        rec = eng.recorder.registry
        for pool in ("prefill", "decode"):
            assert rec.get_sample_value("serve_pool_queue_depth",
                                        {"pool": pool}) is not None
    finally:
        stop(eng)


def test_pools_decode_advances_between_chunks(weights):
    eng = pooled(weights, prefill_chunk=16)
    try:
        short = eng.submit([1, 2, 3], 60, 0.0)
        wait_until(lambda: eng.steps_run > 2, "the short request decoding")
        marker = len(eng.prefill_chunk_trace)
        long_prompt = list(range(1, 97))           # six chunks or more
        assert eng.submit(long_prompt, 4, 0.0).result(
            timeout=TIMEOUT) == direct(weights, long_prompt, 4)
        trace = eng.prefill_chunk_trace[marker:]
        assert len(trace) >= 2
        assert trace[-1] > trace[0], trace
        short.result(timeout=TIMEOUT)
    finally:
        stop(eng)


def test_refcounts_drain_to_the_prefix_cache_only(weights):
    eng = pooled(weights)
    try:
        futs = [eng.submit(PREFIX + [50 + k] * 4, 4, 0.0) for k in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        wait_until(lambda: all(sl is None for sl in eng._slots),
                   "slots released")
        with eng._mu:
            assert eng.pages_in_use == eng.prefix_index.pages_held() > 0
            assert (set(eng._alloc.outstanding_rows())
                    == eng.prefix_index.rows_held())
            eng.prefix_index.clear()
            assert eng._alloc.outstanding_rows() == {}
            assert eng.pages_in_use == 0
    finally:
        stop(eng)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefill_kill_fails_no_request_and_counts_one_restart(weights):
    eng = pooled(weights, prefill_chunk=16)
    try:
        futs = [eng.submit(PREFIX + [70 + k] * 40, 6, 0.0)
                for k in range(6)]
        wait_until(lambda: eng.prefill_workers_alive() == 2, "the pool up")
        eng.fault_kill_prefill = True
        wait_until(lambda: eng.prefill_workers_alive() < 2,
                   "a prefill worker to die")
        assert eng.restart_dead_prefill_workers() == 1
        assert eng.prefill_worker_restarts == 1
        assert eng.prefill_workers_alive() == 2
        for k, f in enumerate(futs):
            assert f.result(timeout=TIMEOUT) == direct(
                weights, PREFIX + [70 + k] * 40, 6), k
        assert eng.restart_dead_prefill_workers() == 0
        wait_until(lambda: all(sl is None for sl in eng._slots),
                   "slots released")
        with eng._mu:
            eng.prefix_index.clear()
            assert eng._alloc.outstanding_rows() == {}
    finally:
        stop(eng)
