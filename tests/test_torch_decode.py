"""Port of models/decode on the CPU: decode_step logits and generate
tokens held against the JAX package on weights carried across with
interop.params_from_jax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import llama as tllama

# head_dim 128 with use_flash=True: the JAX side runs its pallas decode
# kernel (interpret mode), whose f32 p.v is what the port computes.
WIDE = dict(d_model=512, n_heads=4, n_kv_heads=2, vocab_size=128)
# f32 end to end; sums in another order through two layers: 1e-4.
LOGITS_TOL = 1e-4


def _pair(dtype: str, wide: bool, seed: int = 0, quant: bool = False):
    """(JAX params, JAX cfg, port model, port cfg) on the same weights."""
    kw = WIDE if wide else {}
    jcfg = jllama.llama_tiny(dtype=getattr(jnp, dtype),
                             use_flash=True if wide else None, **kw)
    tcfg = tllama.llama_tiny(dtype=getattr(torch, dtype), **kw)
    params = jllama.init_params(jax.random.key(seed), jcfg)
    if quant:
        params = jquant.quantize_llama_params(params)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape)


@pytest.mark.parametrize("wide", [False, True])
def test_decode_step_logits_scalar_length(wide):
    params, jcfg, model, tcfg = _pair("float32", wide)
    toks = _tokens(0, (2, 9), tcfg.vocab_size)
    max_len = 256 if wide else 32   # the pallas kernel wants 256
    step = jdecode._jitted_decode_step(jcfg)
    jcache = jdecode.init_cache(jcfg, 2, max_len)
    jl1, jcache = step(params, jcache, jnp.asarray(toks, jnp.int32))
    jl2, jcache = step(params, jcache, jnp.asarray(toks[:, :1], jnp.int32))
    cache = decode.init_cache(tcfg, 2, max_len, "cpu")
    tl1, cache = decode.decode_step(model, cache, torch.from_numpy(toks),
                                    tcfg)
    tl2, cache = decode.decode_step(model, cache,
                                    torch.from_numpy(toks[:, :1]), tcfg)
    assert cache.length == int(jcache.length) == 10
    assert tl1.dtype == torch.float32 and tl1.shape == (2, 9, 128 if wide
                                                          else 512)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    # The cache rows written in place hold what JAX wrote.
    np.testing.assert_allclose(cache.k[:, :, :10].numpy(),
                               np.asarray(jcache.k)[:, :, :10],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_decode_step_per_slot_lengths_and_active_gating():
    params, jcfg, model, tcfg = _pair("float32", wide=True, seed=1)
    max_len = 256
    # Slot 3 sits at the end of its cache: its row length is clamped to
    # max_len - T, as in the JAX package.
    lengths = np.array([0, 5, 129, max_len], np.int32)
    active = np.array([True, False, True, True])
    rs = np.random.RandomState(2)
    jcache = jdecode.init_slot_cache(jcfg, 4, max_len)
    k0 = rs.randn(*jcache.k.shape).astype(np.float32)
    v0 = rs.randn(*jcache.v.shape).astype(np.float32)
    jcache = jcache._replace(k=jnp.asarray(k0), v=jnp.asarray(v0),
                             length=jnp.asarray(lengths))
    cache = decode.init_slot_cache(tcfg, 4, max_len, "cpu")
    cache = dataclasses.replace(cache, k=torch.from_numpy(k0.copy()),
                                v=torch.from_numpy(v0.copy()),
                                length=torch.from_numpy(lengths))
    step_fn = jdecode._jitted_decode_step_slots(jcfg)
    for step in range(2):
        toks = _tokens(10 + step, (4,), tcfg.vocab_size)
        jl, jcache = step_fn(params, jcache, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(active))
        tl, cache = decode.decode_step_slots(
            model, cache, torch.from_numpy(toks), torch.from_numpy(active),
            tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)
        np.testing.assert_array_equal(cache.length.numpy(),
                                      np.asarray(jcache.length))
    assert cache.length.tolist() == [2, 5, 131, max_len]


def _jax_generate(params, jcfg, prompt, n_new):
    out = jdecode.generate(params, jnp.asarray(prompt, jnp.int32), jcfg,
                           n_new)
    return np.asarray(out)


@pytest.mark.parametrize("dtype,wide,quant", [
    ("float32", False, False),
    ("bfloat16", True, False),
    ("bfloat16", True, True),
])
def test_greedy_generate_matches_jax(dtype, wide, quant):
    # Greedy tokens must be identical. In bf16 the two sides round a few
    # elementwise results differently (XLA:CPU rounds every step of its
    # sigmoid to bf16), so identity holds where the reference's top-2
    # margin exceeds that noise; these fixed inputs were checked to.
    params, jcfg, model, tcfg = _pair(dtype, wide, quant=quant)
    prompt = _tokens(3, (2, 7), tcfg.vocab_size)
    want = _jax_generate(params, jcfg, prompt, 4)
    got = decode.generate(model, torch.from_numpy(prompt), tcfg, 4)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_seeded_and_in_vocab():
    cfg = tllama.llama_tiny()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(_tokens(4, (3, 5), cfg.vocab_size))

    def run(seed):
        return decode.generate(model, prompt, cfg, 6, temperature=0.8,
                               generator=torch.Generator().manual_seed(seed))

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert a.shape == (3, 11) and torch.equal(a[:, :5], prompt)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_pick_tokens_greedy_rows_take_the_argmax():
    logits = torch.from_numpy(
        np.random.RandomState(5).randn(4, 50).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.5])
    got = decode.pick_tokens(logits, temps, torch.Generator().manual_seed(0))
    assert got[0] == logits[0].argmax() and got[2] == logits[2].argmax()
    assert ((got >= 0) & (got < 50)).all()


def test_unported_kv_modes_raise():
    cfg = tllama.llama_tiny(kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError):
        decode.init_cache(cfg, 1, 16, "cpu")


def test_scalar_cache_overflow_raises():
    cfg = tllama.llama_tiny()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = decode.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError):
        decode.decode_step(model, cache, torch.zeros(1, 9, dtype=torch.long),
                           cfg)
