"""Port of the int8 weight path: the quantizer bit for bit against the
JAX package and the plain int8_matmul against the JAX pallas kernel
(interpret mode), on the CPU. The CUDA kernel is held against the plain
version in test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu_torch import interop, kernels
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import quant


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
def test_quantize_weights_bit_exact(shape):
    w = (np.random.RandomState(0).randn(*shape) * 0.05).astype(np.float32)
    w[..., 0, 1] = 0.0        # an all-but-zero column keeps its floor
    w[..., :, 2] = 0.0        # an all-zero column: scale floor 1e-8/127
    jq = jax.device_get(jquant.quantize_weights(jnp.asarray(w)))
    tq = quant.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(
        quant.dequantize(tq, torch.float32).numpy(),
        np.asarray(jquant.dequantize(jq, jnp.float32)))


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t", [1, 8, 13])
def test_int8_matmul_plain_matches_pallas(x_dtype, t):
    # Both sum exact int8 x x products in f32, in another order: 1e-5
    # relative in f32; the bf16 output may round one bf16 ulp apart.
    rs = np.random.RandomState(t)
    np_dt = ml_dtypes.bfloat16 if x_dtype == "bfloat16" else np.float32
    x = rs.randn(t, 256).astype(np_dt)
    w = (rs.randn(256, 1024) * 0.05).astype(np.float32)
    jq = jquant.quantize_weights(jnp.asarray(w))
    want = np.asarray(jax.device_get(
        jquant.int8_matmul(jnp.asarray(x), jq, interpret=True)))
    tq = quant.quantize_weights(torch.from_numpy(w))
    got = quant.int8_matmul_plain(interop.to_torch(x), tq)
    assert got.dtype == interop.to_torch(want).dtype
    tol = 1e-5 if x_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=tol, atol=tol)


def test_cpu_dispatch_is_the_plain_version():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    qw = quant.quantize_weights(torch.randn(64, 32))
    kernels.reset_launches()
    torch.testing.assert_close(quant.int8_matmul(x, qw),
                               quant.int8_matmul_plain(x, qw),
                               rtol=0, atol=0)
    assert kernels.launches["int8_matmul"] == 0
    with pytest.raises(ValueError):
        quant.int8_matmul_plain(x[:, :32], qw)


def test_quantize_llama_params_covers_projections_and_head():
    cfg = tllama.llama_tiny()
    model = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    qmodel = quant.quantize_llama_params(model)
    for layer, qlayer in zip(model.layers, qmodel.layers):
        for name in tllama.LlamaLayer.WEIGHTS:
            qw = getattr(qlayer, name)
            if name in quant.QUANT_KEYS:
                assert isinstance(qw, quant.QuantWeight), name
                assert qw.shape == getattr(layer, name).shape
            else:
                assert qw is getattr(layer, name), name
    assert isinstance(qmodel.lm_head, quant.QuantWeight)
    assert qmodel.embed is model.embed
    # The source model is left as it was.
    assert not isinstance(model.layers[0].wq, quant.QuantWeight)


@pytest.mark.parametrize("sms", [132, 114])     # H100 SXM and PCIe
@pytest.mark.parametrize("t,d,f", [(8, 4096, 14336), (8, 4096, 128256),
                                   (1024, 4096, 4096), (1, 14336, 4096)])
def test_contraction_split_covers_d_exactly(t, d, f, sms):
    splits, per = quant._splits(t, d, f, sms)
    assert splits >= 1 and per * (splits - 1) < d <= per * splits
