"""Port parity on the CPU: RMSNorm, RoPE, the Llama config and the JAX
parameter carry-over, each held against the JAX package on the same
numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import rms_norm as j_rms_norm
from container_engine_accelerators_tpu.ops.rope import (
    apply_rope as j_apply_rope,
    rope_frequencies as j_rope_frequencies,
)
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)

_DT = {"float32": (np.float32, jnp.float32, torch.float32),
       "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    # f32 statistics on both sides; tolerance: a few f32 ulps, or one
    # bf16 ulp (2^-8 relative) where the output rounds to bf16.
    np_dt, _, _ = _DT[dtype]
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 64).astype(np_dt)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    want = _f32(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = _f32(rms_norm(interop.to_torch(x), torch.from_numpy(w), 1e-5))
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_rope_tables_match_jax():
    # Positions up to 2047 rad-scaled: cos/sin of the same f32 argument,
    # so only the libm ulp differs (atol 1e-5).
    cj, sj = j_rope_frequencies(64, 2048, 500_000.0)
    ct, st = rope_frequencies(64, 2048, 500_000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)


@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(with_positions, dtype):
    # Same f32 rotation of the same table rows; atol 1e-5 in f32, one
    # bf16 ulp of |x| <~ 4 where the output rounds to bf16.
    np_dt, _, _ = _DT[dtype]
    rs = np.random.RandomState(1)
    b, s, h, d = 2, 6, 3, 32
    x = rs.randn(b, s, h, d).astype(np_dt)
    cos, sin = rope_frequencies(d, 256)
    cj, sj = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    pos = rs.randint(0, 256, size=(b, s)) if with_positions else None
    want = _f32(j_apply_rope(jnp.asarray(x), cj, sj,
                             positions=None if pos is None
                             else jnp.asarray(pos, jnp.int32)))
    got = _f32(apply_rope(interop.to_torch(x), cos, sin,
                          positions=None if pos is None
                          else torch.from_numpy(pos)))
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("preset", ["llama3_8b", "llama3_1b", "llama_tiny"])
def test_config_presets_match_jax(preset):
    jc = getattr(jllama, preset)()
    tc = getattr(tllama, preset)()
    for f in dataclasses.fields(tc):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.head_dim == jc.head_dim
    assert tc.num_params() == jc.num_params()


def test_config_json_round_trips_both_ways():
    tc = tllama.llama_tiny(dtype=torch.float32, d_model=96, n_heads=3)
    d = tllama.cfg_to_json_dict(tc)
    assert d["dtype"] == "float32" and d["param_dtype"] == "float32"
    assert tllama.cfg_from_json_dict(d) == tc
    # The JAX package reads the port's JSON and vice versa.
    jc = jllama.cfg_from_json_dict(d)
    assert jc.d_model == 96 and jc.dtype == jnp.float32
    back = tllama.cfg_from_json_dict(jllama.cfg_to_json_dict(jc))
    assert back == tc
    # A mixture of experts loads; experts sharded over tensor
    # parallelism at decode wait for the port's tensor parallelism.
    assert tllama.cfg_from_json_dict({**d, "n_experts": 4}).n_experts == 4
    with pytest.raises(NotImplementedError, match="moe_decode_ep"):
        tllama.cfg_from_json_dict({**d, "n_experts": 4,
                                   "moe_decode_ep": True})


def test_params_from_jax_moves_bits_exactly():
    cfg_j = jllama.llama_tiny(n_layers=3, param_dtype=jnp.bfloat16)
    cfg_t = tllama.llama_tiny(n_layers=3)
    tree = jax.device_get(jllama.init_params(jax.random.key(3), cfg_j))
    model = interop.params_from_jax(tree, cfg_t)
    assert len(model.layers) == 3
    for li, layer in enumerate(model.layers):
        for name in tllama.layer_weights(cfg_t):
            got = getattr(layer, name)
            want = np.asarray(tree["layers"][name][li])
            assert got.dtype == (torch.float32 if name.endswith("norm")
                                 else torch.bfloat16), name
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    # bf16 arrays are carried by bits, not through a float conversion.
    embed = np.asarray(tree["embed"])
    np.testing.assert_array_equal(
        model.embed.detach().view(torch.int16).numpy().view(np.uint16),
        embed.view(np.uint16))
    assert model.lm_head.dtype == torch.float32


def test_init_params_shapes_and_dtypes():
    cfg = tllama.llama_tiny()
    gen = torch.Generator().manual_seed(0)
    model = tllama.init_params(cfg, gen, "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.num_params()
    assert model.embed.dtype == cfg.dtype
    assert model.layers[0].wq.shape == (cfg.d_model, cfg.d_model)
    assert model.lm_head.dtype == torch.float32
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.layers[1].w_up, model.layers[1].w_up)
