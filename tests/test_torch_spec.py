"""Port of speculative decoding (models/spec.py, decode.verify_step,
advance_lengths and the speculative generate) on the CPU, held against
the JAX package on weights carried across with interop.params_from_jax:
the drafter and the acceptance rule give equal outputs, the self-draft
shares the model's storage, verify logits equal JAX's within LOGITS_TOL
with the lengths unmoved, rejected writes stay invisible, and the
speculative generate gives JAX's tokens and the port's own plain ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.models import spec as jspec
from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import decode, spec
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops.quant import (
    quantize_llama_params,
)

# f32 end to end, sums in another order through two layers: the decode
# tests' tolerance.
LOGITS_TOL = 1e-4
REPETITIVE = [5, 9, 7, 5, 9, 7, 5, 9, 7, 5, 9]
RANDOM = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(scope="module")
def pair():
    """(JAX params, JAX cfg, port model, port cfg): llama_tiny, 2 layers,
    f32, one set of weights."""
    jcfg = jllama.llama_tiny(dtype=jnp.float32, n_layers=2)
    tcfg = tllama.llama_tiny(dtype=torch.float32, n_layers=2)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


# ---------- drafter and acceptance rule ----------

NGRAM_CASES = [
    ([10, 11, 12, 13, 10, 11], 2), ([1, 2, 3, 7, 2, 3, 8, 2, 3], 1),
    ([1, 2, 3, 4, 5], 4), ([], 4), ([1, 2, 3, 4, 5, 6, 1, 2], 3),
    ([1, 2, 3, 4, 5, 6, 1, 2], 2), ([4, 4], 3), ([7], 2), ([7, 7], 0),
]


@pytest.mark.parametrize("context,k", NGRAM_CASES)
def test_ngram_draft_edge_cases_match_jax(context, k):
    assert spec.ngram_draft(context, k) == jspec.ngram_draft(context, k)


def test_ngram_draft_matches_jax_on_seeded_contexts():
    rs = np.random.RandomState(0)
    for _ in range(200):
        n, vocab = rs.randint(0, 40), rs.randint(2, 8)
        ctx = rs.randint(0, vocab, size=n).tolist()
        k, lo = rs.randint(0, 8), rs.randint(1, 3)
        hi = lo + rs.randint(0, 3)
        assert (spec.ngram_draft(ctx, k, max_ngram=hi, min_ngram=lo)
                == jspec.ngram_draft(ctx, k, max_ngram=hi, min_ngram=lo))


def test_greedy_verify_matches_jax():
    rs = np.random.RandomState(1)
    cases = [(np.array([[7, 3, 4, 5]]), np.array([[3, 4, 9, 2]])),
             (np.array([[7, 1, 1, 1], [2, 8, 8, 8]]),
              np.array([[5, 6, 7, 8], [8, 8, 8, 4]])),
             (np.array([[1], [2]]), np.array([[4], [5]]))]
    for _ in range(50):
        b, k1 = rs.randint(1, 5), rs.randint(1, 8)
        tokens = rs.randint(0, 3, size=(b, k1))
        cases.append((tokens, rs.randint(0, 3, size=(b, k1))))
    for tokens, greedy in cases:
        got = spec.greedy_verify(greedy, tokens)
        want = jspec.greedy_verify(greedy, tokens)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    counts, bonus = spec.greedy_verify(cases[1][1], cases[1][0])
    assert counts.tolist() == [1, 4] and bonus.tolist() == [5, 4]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_truncate_params_shares_storage(pair, quant):
    _, _, model, cfg = pair
    if quant:
        model = quantize_llama_params(model)
    draft = spec.truncate_params(model, 1)
    assert draft.cfg == spec.draft_config(model.cfg, 1)
    assert draft.cfg.n_layers == 1 and len(draft.layers) == 1
    assert draft.layers[0] is model.layers[0]
    for name in ("embed", "final_norm"):
        assert (getattr(draft, name).data_ptr()
                == getattr(model, name).data_ptr())
    head, want = draft.lm_head, model.lm_head
    if quant:
        assert head.values.data_ptr() == want.values.data_ptr()
        assert head.scales.data_ptr() == want.scales.data_ptr()
        assert (draft.layers[0].wq.values.data_ptr()
                == model.layers[0].wq.values.data_ptr())
    else:
        assert head.data_ptr() == want.data_ptr()
        assert (draft.layers[0].wq.data_ptr()
                == model.layers[0].wq.data_ptr())


# ---------- verify_step and advance_lengths ----------

def _slot_caches(jcfg, tcfg, lengths, max_len, seed):
    """A JAX and a port slot cache holding the same random K/V and
    per-slot lengths."""
    rs = np.random.RandomState(seed)
    jcache = jdecode.init_slot_cache(jcfg, len(lengths), max_len)
    k0 = rs.randn(*jcache.k.shape).astype(np.float32)
    v0 = rs.randn(*jcache.v.shape).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jcache = jcache._replace(k=jnp.asarray(k0), v=jnp.asarray(v0),
                             length=jnp.asarray(lens))
    cache = decode.init_slot_cache(tcfg, len(lengths), max_len, "cpu")
    cache = decode.KVCache(k=torch.from_numpy(k0.copy()),
                           v=torch.from_numpy(v0.copy()),
                           length=torch.from_numpy(lens.copy()))
    return jcache, cache


def test_verify_step_matches_jax_and_moves_no_length(pair):
    params, jcfg, model, tcfg = pair
    lengths, max_len = [0, 7, 30, 59], 64
    jcache, cache = _slot_caches(jcfg, tcfg, lengths, max_len, seed=2)
    toks = np.random.RandomState(3).randint(0, tcfg.vocab_size, (4, 5))
    active = np.array([True, True, False, True])
    jl, jcache = jdecode._jitted_verify_step(jcfg)(
        params, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(active))
    tl, cache = decode.verify_step(model, cache, torch.from_numpy(toks),
                                   torch.from_numpy(active), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    assert cache.length.tolist() == lengths == np.asarray(
        jcache.length).tolist()
    # The candidates' K/V are written, as JAX writes them.
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(cache.k[:, b, n:n + 5].numpy(),
                                   np.asarray(jcache.k)[:, b, n:n + 5],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_verify_step_on_a_paged_cache_matches_jax(pair):
    params, jcfg, model, tcfg = pair
    page, max_pages = 8, 4
    lengths = np.array([6, 13, 0], np.int32)   # slot 0 straddles a page
    tables = np.array([[3, 5, 0, 0], [1, 2, 4, 0], [6, 0, 0, 0]], np.int32)
    jcache = jdecode.init_paged_cache(jcfg, 3, 8, page, max_pages)
    rs = np.random.RandomState(4)
    k0 = rs.randn(*jcache.k_pool.shape).astype(np.float32)
    v0 = rs.randn(*jcache.v_pool.shape).astype(np.float32)
    jcache = jcache._replace(k_pool=jnp.asarray(k0), v_pool=jnp.asarray(v0),
                             tables=jnp.asarray(tables),
                             length=jnp.asarray(lengths))
    cache = decode.PagedKVCache(
        k_pool=torch.from_numpy(k0.copy()), v_pool=torch.from_numpy(v0.copy()),
        tables=torch.from_numpy(tables.copy()),
        length=torch.from_numpy(lengths.copy()))
    toks = rs.randint(0, tcfg.vocab_size, (3, 5))
    active = np.array([True, True, False])
    jl, jcache = jdecode._jitted_verify_step(jcfg)(
        params, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(active))
    tl, cache = decode.verify_step(model, cache, torch.from_numpy(toks),
                                   torch.from_numpy(active), tcfg)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    assert cache.length.tolist() == lengths.tolist()
    # Slot 0's window [6, 11) lands in pages 3 and 5 of the pool.
    np.testing.assert_allclose(cache.k_pool[:, 5, :3].numpy(),
                               np.asarray(jcache.k_pool)[:, 5, :3],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_advance_lengths_matches_jax():
    jcfg = jllama.llama_tiny(dtype=jnp.float32)
    tcfg = tllama.llama_tiny(dtype=torch.float32)
    lengths = np.array([0, 5, 60, 62], np.int32)
    counts = np.array([3, 0, 5, 4], np.int32)
    for active in (None, np.array([True, False, True, True])):
        jcache, cache = _slot_caches(jcfg, tcfg, lengths, 64, seed=5)
        jact = None if active is None else jnp.asarray(active)
        tact = None if active is None else torch.from_numpy(active)
        want = jdecode.advance_lengths(jcache, jnp.asarray(counts), jact)
        got = decode.advance_lengths(cache, torch.from_numpy(counts), tact)
        assert got.length.dtype == torch.int32
        np.testing.assert_array_equal(got.length.numpy(),
                                      np.asarray(want.length))
        # Clamped at the capacity.
        assert got.length.max().item() == 64


def test_rejected_verify_writes_are_invisible(pair):
    """A verify writes K/V for all k+1 candidates but commits one: the
    rejected positions sit past the live length and the next steps
    overwrite them, so the stream equals a never-speculated run's, and
    JAX's run of the same steps."""
    params, jcfg, model, tcfg = pair
    active = torch.tensor([True])
    prompt = RANDOM[:4]

    def prefilled():
        cache = decode.init_slot_cache(tcfg, 1, 64, "cpu")
        last, cache = decode.prefill_slot(
            model, cache, 0, torch.tensor(prompt + [0] * 4), len(prompt),
            tcfg)
        return int(last.argmax()), cache

    tok, cache = prefilled()
    ref, cur = [], tok
    for _ in range(4):
        lg, cache = decode.decode_step_slots(model, cache,
                                             torch.tensor([cur]), active,
                                             tcfg)
        cur = int(lg[0].argmax())
        ref.append(cur)

    tok2, cache = prefilled()
    assert tok2 == tok
    logits, cache = decode.verify_step(
        model, cache, torch.tensor([[tok, 99, 98, 97]]), active, tcfg)
    got = [int(logits[0, 0].argmax())]
    cache = decode.advance_lengths(cache, torch.tensor([1]), active)
    cur = got[0]
    for _ in range(3):
        lg, cache = decode.decode_step_slots(model, cache,
                                             torch.tensor([cur]), active,
                                             tcfg)
        cur = int(lg[0].argmax())
        got.append(cur)
    assert got == ref

    # The JAX package's steps give the same tokens.
    jcache = jdecode.init_slot_cache(jcfg, 1, 64)
    last, jcache = jdecode.prefill_slot(
        params, jcache, jnp.int32(0), jnp.asarray(prompt + [0] * 4, jnp.int32),
        jnp.int32(len(prompt)), jcfg)
    jact = jnp.asarray([True])
    jl, jcache = jdecode._jitted_verify_step(jcfg)(
        params, jcache, jnp.asarray([[tok, 99, 98, 97]], jnp.int32), jact)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    jcache = jdecode.advance_lengths(jcache, jnp.asarray([1], jnp.int32),
                                     jact)
    want, cur = [int(jnp.argmax(jl[0, 0]))], int(jnp.argmax(jl[0, 0]))
    for _ in range(3):
        lg, jcache = jdecode.decode_step_slots(
            params, jcache, jnp.asarray([cur], jnp.int32), jact, jcfg)
        cur = int(jnp.argmax(lg[0]))
        want.append(cur)
    assert got == want


# ---------- speculative generate ----------

_JAX_SPEC: dict = {}


def _jax_spec(params, jcfg, prompt, mode, k):
    """JAX's speculative tokens and spec_stats, once per case."""
    key = (tuple(map(tuple, prompt)), mode, k)
    if key not in _JAX_SPEC:
        stats: dict = {}
        out = jdecode.generate(params, jnp.asarray(prompt, jnp.int32), jcfg,
                               12, speculate=mode, spec_k=k, draft_layers=1,
                               spec_stats=stats)
        _JAX_SPEC[key] = (np.asarray(out), stats)
    return _JAX_SPEC[key]


PROMPTS = {"repetitive": [REPETITIVE],
           "rejection_heavy": [RANDOM],
           "batch_rows_diverge": [REPETITIVE[:8], RANDOM]}


@pytest.mark.parametrize("k", [1, 4, 7])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_speculative_generate_matches_jax_and_plain(pair, prompt, mode, k):
    params, jcfg, model, tcfg = pair
    p = np.asarray(PROMPTS[prompt], np.int64)
    want, want_stats = _jax_spec(params, jcfg, p, mode, k)
    stats: dict = {}
    got = decode.generate(model, torch.from_numpy(p), tcfg, 12,
                          speculate=mode, spec_k=k, draft_layers=1,
                          spec_stats=stats)
    assert got.dtype == torch.long and got.shape == (len(p), p.shape[1] + 12)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = decode.generate(model, torch.from_numpy(p), tcfg, 12)
    assert torch.equal(got, plain)
    assert stats == want_stats
    if mode == "draft":
        assert stats["verifies"] > 0
    if stats:
        assert stats["committed"] >= stats["verifies"]
        assert 0 <= stats["accepted"] <= stats["drafted"]


def test_speculative_generate_refuses_sampling_and_bad_k(pair):
    _, _, model, cfg = pair
    p = torch.ones(1, 4, dtype=torch.long)
    with pytest.raises(ValueError):
        decode.generate(model, p, cfg, 4, temperature=0.7,
                        speculate="ngram")
    with pytest.raises(ValueError):
        decode.generate(model, p, cfg, 4, speculate="ngram", spec_k=0)
    with pytest.raises(ValueError):
        decode.generate(model, p, cfg, 4, speculate="medusa")


def test_draft_on_int8_weights_matches_jax(pair):
    """The self-draft over QuantWeight layers: the truncation shares the
    quantized leaves on both sides, and the tokens are JAX's."""
    params, jcfg, model, tcfg = pair
    qparams = jquant.quantize_llama_params(params)
    qmodel = interop.params_from_jax(jax.device_get(qparams), tcfg)
    p = np.asarray([REPETITIVE], np.int64)
    want = jdecode.generate(qparams, jnp.asarray(p, jnp.int32), jcfg, 10,
                            speculate="draft", spec_k=4, draft_layers=1)
    got = decode.generate(qmodel, torch.from_numpy(p), tcfg, 10,
                          speculate="draft", spec_k=4, draft_layers=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
