"""Port of the decode-attention kernel: the plain PyTorch version held
against the JAX package's pallas kernel (interpret mode) on the CPU. The
CUDA kernel is held against the plain version in
test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops.decode_attention import (
    decode_attention as j_decode_attention,
)
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_cuda,
    decode_attention_plain,
)

# f32 inputs, f32 math on both sides, sums in another order: 2e-5.
TOL = 2e-5


def _inputs(seed, b, t, hq, hkv, d, max_len, dtype=np.float32):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, t, hq, d).astype(dtype)
    k = rs.randn(b, max_len, hkv, d).astype(dtype)
    v = rs.randn(b, max_len, hkv, d).astype(dtype)
    return q, k, v


def _jax(q, k, v, cache_len):
    out = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(cache_len, jnp.int32),
                             interpret=True)
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("t,cache_len", [(1, 0), (1, 127), (1, 128),
                                         (1, 255), (5, 0), (5, 123),
                                         (5, 251)])
def test_plain_matches_pallas_scalar_length(t, cache_len):
    q, k, v = _inputs(cache_len * 7 + t, 2, t, 8, 2, 128, 256)
    want = _jax(q, k, v, cache_len)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), cache_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 5])
def test_plain_matches_pallas_per_slot_lengths(t):
    lens = np.array([0, 127, 128, 256 - t], np.int32)
    q, k, v = _inputs(11 + t, 4, t, 8, 2, 128, 256)
    want = _jax(q, k, v, lens)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_dead_positions_never_reach_the_output():
    # NaN past the live length (a reused cache makes no promise there)
    # must not leak: the plain version zeroes dead rows, as the kernels do.
    q, k, v = _inputs(5, 2, 3, 4, 4, 64, 300)
    lens = torch.tensor([130, 7], dtype=torch.int32)
    kp, vp = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    for row, n in enumerate(lens.tolist()):
        kp[row, n + 3:] = float("nan")
        vp[row, n + 3:] = float("nan")
    got = decode_attention_plain(torch.from_numpy(q), kp, vp, lens)
    want = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_dispatch_is_the_plain_version():
    q, k, v = _inputs(2, 2, 1, 4, 2, 32, 40)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 9)
    kernels.reset_launches()
    torch.testing.assert_close(decode_attention(*args),
                               decode_attention_plain(*args),
                               rtol=0, atol=0)
    assert kernels.launches["decode_attention"] == 0
    with pytest.raises(ValueError):
        decode_attention_plain(*args[:3], torch.tensor([1, 2, 3]))


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("args,error", [
    ((_bf16(1, 1, 4, 96), _bf16(1, 16, 2, 96), _bf16(1, 16, 2, 96), 0),
     ValueError),                                      # head_dim 96
    ((_bf16(1, 1, 4, 64).float(), _bf16(1, 16, 2, 64).float(),
      _bf16(1, 16, 2, 64).float(), 0), TypeError),     # f32
    ((_bf16(1, 1, 4, 64), _bf16(1, 2, 16, 64).transpose(1, 2),
      _bf16(1, 16, 2, 64), 0), ValueError),            # strided cache
    ((_bf16(2, 1, 4, 64), _bf16(2, 16, 2, 64), _bf16(2, 16, 2, 64),
      torch.tensor([1, 2, 3])), ValueError),           # lengths not [B]
    ((_bf16(1, 1, 3, 64), _bf16(1, 16, 2, 64), _bf16(1, 16, 2, 64), 0),
     ValueError),                                      # Hq % Hkv != 0
    ((_bf16(1, 1, 4, 64), _bf16(1, 16, 2, 64), _bf16(1, 16, 2, 32), 0),
     ValueError),                                      # k, v differ
])
def test_kernel_wrapper_refuses_before_launch(args, error):
    # The wrapper checks every argument before it builds or launches the
    # kernel, so a shape the kernel cannot take raises here, on the CPU.
    kernels.reset_launches()
    with pytest.raises(error):
        decode_attention_cuda(*args)
    assert kernels.launches["decode_attention"] == 0
