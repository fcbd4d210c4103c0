"""Port of flash attention: the plain PyTorch versions of K4-K6, run
through the port's autograd.Function on the CPU, held against the JAX
package's pallas kernels in interpret mode and `jax.grad` of them; and
the port's reference attention and dispatch against JAX's. The CUDA
kernels are held against the plain versions in
test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import attention as jattn
from container_engine_accelerators_tpu.ops import flash_attention as jfa
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.ops import attention as tattn
from container_engine_accelerators_tpu_torch.ops import flash_attention as tfa

B, S, HQ, HKV, D = 1, 256, 4, 2, 128
# f32: the same arithmetic in another tile order (the backward's 64-key
# and 32-query tiles against the JAX run's 128): 1e-5 of the largest
# |o|, gradients 1e-4 of the largest |grad|.
F32_OUT_TOL, F32_GRAD_TOL = 1e-5, 1e-4
# bf16: p is rounded to bf16 against a running max taken over other
# tiles, so an output element may round one bf16 ulp apart: per row, at
# most 2^-7 of the row's largest |o|. Gradients: 2^-6 of the largest
# |grad|, since dk/dv also sum the GQA group in f32 before rounding
# where JAX rounds each repeated head and sums in bf16.
BF16_ROW_TOL, BF16_GRAD_TOL = 2 ** -7, 2 ** -6


def _inputs(seed, segmented):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, HQ, D).astype(np.float32)
    k = rs.randn(B, S, HKV, D).astype(np.float32)
    v = rs.randn(B, S, HKV, D).astype(np.float32)
    w = rs.randn(B, S, HQ, D).astype(np.float32)   # d loss / d out
    seg = ((np.arange(S)[None, :] // 96).astype(np.int32)
           if segmented else None)
    return q, k, v, w, seg


def _jax_run(q, k, v, w, seg, dtype, causal):
    jd = getattr(jnp, dtype)

    def loss(q, k, v):
        o = jfa.flash_attention(
            q, k, v, causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=128, block_k=128, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    args = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_run(q, k, v, w, seg, dtype, causal, **kw):
    td = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(
        *args, causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [x.detach().float().numpy()
            for x in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("segmented", [False, True])
def test_plain_flash_and_grads_match_jax_interpret(dtype, causal,
                                                   segmented):
    q, k, v, w, seg = _inputs(3, segmented)
    want = _jax_run(q, k, v, w, seg, dtype, causal)
    got = _torch_run(q, k, v, w, seg, dtype, causal)
    out_w, out_g = want[0], got[0]
    if dtype == "float32":
        assert np.abs(out_g - out_w).max() <= (
            F32_OUT_TOL * np.abs(out_w).max())
        grad_tol = F32_GRAD_TOL
    else:
        row_err = np.abs(out_g - out_w).max(-1)
        assert (row_err <= BF16_ROW_TOL * np.abs(out_w).max(-1)).all()
        grad_tol = BF16_GRAD_TOL
    for name, g, gw in zip("qkv", got[1:], want[1:]):
        assert np.abs(g - gw).max() <= grad_tol * np.abs(gw).max(), name


def test_segments_isolate_packed_sequences():
    # Second segment's outputs equal attention over it alone.
    q, k, v, _, _ = _inputs(4, False)
    seg = torch.from_numpy(np.repeat([[0, 1]], S // 2, axis=1))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.flash_attention(qt, kt, vt, segment_ids=seg)
    h = S // 2
    alone = tattn.reference_attention(qt[:, h:], kt[:, h:], vt[:, h:])
    torch.testing.assert_close(got[:, h:], alone, rtol=2e-5, atol=2e-5)


def test_causal_grids_compute_the_same_and_are_validated():
    q, k, v, _, _ = _inputs(5, False)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    rect = tfa.flash_attention(qt, kt, vt, causal_grid="rect")
    tri = tfa.flash_attention(qt, kt, vt, causal_grid="tri")
    assert torch.equal(rect, tri)
    with pytest.raises(ValueError, match="causal_grid"):
        tfa.flash_attention(qt, kt, vt, causal_grid="triangular")
    with pytest.raises(ValueError, match="causal_grid"):
        tattn.multi_head_attention(qt[:, :8], kt[:, :8], vt[:, :8],
                                   causal_grid="triangular")


def test_plain_flag_takes_the_same_path_on_the_cpu():
    q, k, v, w, _ = _inputs(6, False)
    a = _torch_run(q, k, v, w, None, "bfloat16", True)
    b = _torch_run(q, k, v, w, None, "bfloat16", True, plain=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "full", "segmented"])
def test_reference_attention_matches_jax(dtype, mode):
    rs = np.random.RandomState(7)
    q = rs.randn(2, 40, 4, 32).astype(np.float32)
    k = rs.randn(2, 40, 2, 32).astype(np.float32)
    v = rs.randn(2, 40, 2, 32).astype(np.float32)
    seg = (np.arange(40)[None, :] // 15).repeat(2, 0).astype(np.int32)
    kw = {"causal": mode != "full"}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.reference_attention(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)), **kw,
        segment_ids=jnp.asarray(seg) if mode == "segmented" else None)
    got = tattn.reference_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), **kw,
        segment_ids=torch.from_numpy(seg) if mode == "segmented" else None)
    want = np.asarray(want.astype(jnp.float32))
    # f32: another summation order. bf16: one ulp of the output.
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(got.float().numpy() - want).max() <= (
        tol * np.abs(want).max())


def test_dispatch_follows_the_device_and_the_gate():
    q, k, v, _, _ = _inputs(8, False)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    ref = tattn.reference_attention(qt, kt, vt)
    flash = tfa.flash_attention(qt, kt, vt)
    # use_flash=None on the CPU is the reference; True is flash's plain
    # version; a shape the gate refuses takes the reference either way.
    assert torch.equal(tattn.multi_head_attention(qt, kt, vt), ref)
    assert torch.equal(tattn.multi_head_attention(qt, kt, vt,
                                                  use_flash=True), flash)
    short = [x[:, :128] for x in (qt, kt, vt)]
    assert torch.equal(tattn.multi_head_attention(*short, use_flash=True),
                       tattn.reference_attention(*short))


@pytest.mark.parametrize("s,d", [(256, 128), (256, 64), (100, 128),
                                 (128, 128), (640, 256)])
def test_supported_gate_matches_jax(s, d):
    j = jnp.zeros((1, s, 1, d))
    t = torch.zeros((1, s, 1, d))
    assert tfa.supported(t, t, t) == jfa.supported(j, j, j)


def test_repeat_kv_matches_jax():
    x = np.random.RandomState(9).randn(2, 5, 3, 4).astype(np.float32)
    want = np.asarray(jattn._repeat_kv(jnp.asarray(x), 4))
    np.testing.assert_array_equal(
        tattn.repeat_kv(interop.to_torch(x), 4).numpy(), want)


@pytest.mark.parametrize("bad", ["f32", "head_dim", "seq", "layout"])
def test_kernel_wrappers_refuse_what_the_kernels_cannot_take(bad):
    shape = {"head_dim": (1, 128, 2, 64), "seq": (1, 96, 2, 128)}.get(
        bad, (1, 128, 2, 128))
    dtype = torch.float32 if bad == "f32" else torch.bfloat16
    q = torch.zeros(shape, dtype=dtype)
    if bad == "layout":
        q = torch.zeros((1, 128, 128, 2), dtype=dtype).transpose(2, 3)
    err = TypeError if bad == "f32" else ValueError
    for fn in (tfa.flash_fwd_cuda, tfa.flash_bwd_dq_cuda,
               tfa.flash_bwd_dkv_cuda):
        args = (q, q, q, None) + ((q, None, None) if fn is not
                                  tfa.flash_fwd_cuda else ()) + (True,)
        with pytest.raises(err):
            fn(*args)
