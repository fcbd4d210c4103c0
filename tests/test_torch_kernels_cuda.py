"""The port's CUDA kernels held against their plain PyTorch versions on
the card. Every test is marked `cuda` and skips where
torch.cuda.is_available() is False. This file imports no JAX, so it runs
on a GPU machine without it:

  python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models.llama import (
    init_params,
    llama_tiny,
)
from container_engine_accelerators_tpu_torch.ops import quant
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

pytestmark = pytest.mark.cuda

ROW_RTOL, ROW_ATOL = 2 ** -7, 1e-6   # decode attention, per output row


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.mark.parametrize("d,hq,hkv", [(32, 4, 2), (64, 32, 8),
                                      (128, 32, 8)])
@pytest.mark.parametrize("t", [1, 7, 128])
def test_decode_attention_kernel_matches_plain(cuda, d, hq, hkv, t):
    # bf16 inputs, f32 math in both; the outputs round to bf16, so a
    # different summation order may move an element by one bf16 ulp,
    # at most 2^-7 of the largest |o| of its row. Held per row: a long
    # cache averages |o| down, and one absolute bound would let a few
    # dropped keys pass there.
    b, max_len = 3, 512
    gen = torch.Generator(device=cuda).manual_seed(d + t)
    q = torch.randn(b, t, hq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, max_len, hkv, d, generator=gen,
                    device=cuda).bfloat16()
    v = torch.randn(b, max_len, hkv, d, generator=gen,
                    device=cuda).bfloat16()
    lens = torch.tensor([0, 129, max_len - t], dtype=torch.int32,
                        device=cuda)
    for cache_len in (lens, 64):
        kernels.reset_launches()
        got = decode_attention(q, k, v, cache_len)
        torch.cuda.synchronize()
        assert kernels.launches["decode_attention"] == 1
        want = decode_attention_plain(q, k, v, cache_len)
        err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
        scale = want.float().abs().reshape(-1, d).amax(-1)
        assert bool((err <= ROW_RTOL * scale + ROW_ATOL).all()), (
            (err / scale).max().item())


def test_decode_attention_kernel_ignores_nan_past_live(cuda):
    b, t, hq, hkv, d, max_len = 2, 3, 8, 2, 128, 256
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, t, hq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, max_len, hkv, d, generator=gen,
                    device=cuda).bfloat16()
    v = torch.randn(b, max_len, hkv, d, generator=gen,
                    device=cuda).bfloat16()
    lens = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    want = decode_attention(q, k, v, lens)
    for row, n in enumerate(lens.tolist()):
        k[row, n + t:] = float("nan")
        v[row, n + t:] = float("nan")
    got = decode_attention(q, k, v, lens)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_decode_attention_kernel_raises_on_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 4, 96, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 16, 2, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, 0)
    with pytest.raises(TypeError):
        decode_attention(q[..., :64].float(), k[..., :64].float(),
                         k[..., :64].float(), 0)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,f", [(1, 256, 1032), (8, 4096, 1024),
                                   (37, 1000, 520)])
def test_int8_matmul_kernel_matches_plain(cuda, x_dtype, t, d, f):
    # Exact int8 x x products summed in f32 in another order: 1e-4 of
    # max|y| in f32; one bf16 ulp (2^-8 relative) in bf16.
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    x = torch.randn(t, d, generator=gen, device=cuda).to(x_dtype)
    qw = quant.quantize_weights(
        torch.randn(d, f, generator=gen, device=cuda) * 0.05)
    kernels.reset_launches()
    got = quant.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert kernels.launches["int8_matmul"] == 1
    want = quant.int8_matmul_plain(x, qw)
    tol = 1e-4 if x_dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * want.abs().max().item())


def test_int8_matmul_kernel_raises_on_what_it_cannot_take(cuda):
    qw = quant.quantize_weights(torch.randn(64, 30, device=cuda))
    with pytest.raises(ValueError):
        quant.int8_matmul(torch.randn(2, 64, device=cuda), qw)
    qw = quant.quantize_weights(torch.randn(64, 32, device=cuda))
    with pytest.raises(TypeError):
        quant.int8_matmul(torch.randn(2, 64, device=cuda).half(), qw)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_generate_goes_through_the_kernels(cuda, weights):
    # head_dim 32 (llama_tiny) at bf16: the kernel path and the plain
    # path agree on the first greedy tokens of a random model.
    cfg = llama_tiny()
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    if weights == "int8":
        model = quant.quantize_llama_params(model)
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(1))
    kernels.reset_launches()
    out = decode.generate(model, prompt, cfg, 4)
    torch.cuda.synchronize()
    assert kernels.launches["decode_attention"] == 4 * cfg.n_layers
    if weights == "int8":
        assert kernels.launches["int8_matmul"] == 4 * (7 * cfg.n_layers + 1)
    plain = decode.generate(model, prompt, cfg, 4, plain=True)
    assert out.shape == (2, 13)
    assert torch.equal(out[:, :10], plain[:, :10])
