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
from container_engine_accelerators_tpu_torch.ops import (
    decode_attention as da,
)
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_cuda,
    decode_attention_plain,
    split_plan,
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


# ------------------------------------------------- the kernel's key split

@pytest.mark.parametrize("b,hkv,n_rows,max_len,sms,want", [
    (8, 8, 4, 2048, 132, 9),      # the smoke's and engines' decode
    (8, 8, 4, 2048, 114, 8),      # the same on the PCIe card
    (1, 8, 4, 2048, 132, 32),     # one row: MAX_SPLITS
    (1, 8, 4, 2048, 114, 32),
    (2, 8, 4, 2048, 132, 32),     # 33 wanted, MAX_SPLITS
    (3, 8, 4, 256, 132, 4),       # one split per tile of max_len at most
    (64, 8, 4, 2048, 132, 2),
    (128, 8, 4, 2048, 132, 1),
    (8, 8, 512, 2048, 132, 1),    # prefill: one split
    (8, 8, 5, 2048, 114, 1),
])
def test_split_plan(b, hkv, n_rows, max_len, sms, want):
    assert split_plan(b, hkv, n_rows, max_len, sms) == want


def split_chunk(k_end, splits):
    """Keys of one split's chunk of [0, k_end), as the kernel sizes it
    from the row's length: ceil(k_end / splits) rounded up to a tile.
    Split s takes [s * chunk, (s + 1) * chunk) within [0, k_end)."""
    per_split = -(-k_end // splits)
    return -(-per_split // da.KEY_TILE) * da.KEY_TILE


@pytest.mark.parametrize("k_end,splits,chunk", [
    (1, 9, 64), (64, 9, 64), (577, 9, 128), (2048, 9, 256), (2047, 9, 256),
    (1001, 9, 128), (160, 9, 64), (300, 1, 320), (300, 4, 128)])
def test_split_chunk(k_end, splits, chunk):
    assert split_chunk(k_end, splits) == chunk
    # The chunks cover [0, k_end) with whole tiles, and no more splits
    # than the plan's.
    assert chunk % da.KEY_TILE == 0 and splits * chunk >= k_end


class _RecordingLibrary:
    """Stands in for the kernel library: records the split count each
    entry is called with."""

    def __init__(self):
        self.splits = []

    def __getattr__(self, name):
        def entry(*args):
            # (..., scale, splits, part, tickets, stream)
            self.splits.append(args[-4])
            return 0
        return entry


@pytest.mark.parametrize("paged", [False, True])
def test_wrapper_split_reads_no_length(monkeypatch, paged):
    # The wrapper's split count depends on shapes and the SM count only:
    # the same for any lengths, so a captured CUDA graph replays right
    # after the lengths change on the device.
    lib = _RecordingLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(da, "_tickets", {})
    b, hq, hkv, d, page, max_pages = 8, 32, 8, 128, 128, 16
    q = torch.zeros(b, 1, hq, d, dtype=torch.bfloat16)
    if paged:
        pool = torch.zeros(4, page, hkv, d, dtype=torch.bfloat16)
        tables = torch.zeros(b, max_pages, dtype=torch.int32)
    else:
        cache = torch.zeros(b, page * max_pages, hkv, d, dtype=torch.bfloat16)
    for lens in ([0] * b, [2047] * b, [0, 1, 127, 128, 129, 2047, 1000, 513],
                 5):
        cache_len = torch.tensor(lens) if isinstance(lens, list) else lens
        if paged:
            da.paged_decode_attention_cuda(q, pool, pool, cache_len, tables)
        else:
            decode_attention_cuda(q, cache, cache, cache_len)
    assert lib.splits == [split_plan(b, hkv, 4, 2048, 132)] * 4 == [9] * 4


def _split_emulation(q, k, v, lens, splits):
    """The kernel's decode order in plain f32 torch: per (batch row, KV
    head), split s takes [s * chunk, (s + 1) * chunk) of [0, live), its
    partial (m, l, acc) an online softmax over those keys (m = -1e30 and
    l = 0 where a row sees none of them), and the partials merge in
    split order with weights exp(m_s - max m)."""
    b, t, hq, d = q.shape
    max_len, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = torch.zeros(b, t, hq, d)
    for bi in range(b):
        k_end = min(int(lens[bi]) + t, max_len)
        chunk = split_chunk(k_end, splits)
        qpos = int(lens[bi]) + torch.arange(t * g) // g   # per row t*g + i
        for h in range(hkv):
            rows = q[bi, :, h * g:(h + 1) * g].reshape(t * g, d)
            parts = []
            for sp in range(splits):
                lo = min(sp * chunk, k_end)
                hi = min(lo + chunk, k_end)
                pos = torch.arange(lo, hi)
                s = rows @ k[bi, lo:hi, h].T * d ** -0.5
                ok = pos[None, :] <= qpos[:, None]
                s = s.masked_fill(~ok, -1e30)
                m = (s.amax(-1) if hi > lo
                     else torch.full((t * g,), -1e30))
                p = torch.where(ok, torch.exp(s - m[:, None]), 0.0)
                parts.append((m, p.sum(-1), p @ v[bi, lo:hi, h]))
            m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            l_all = torch.zeros(t * g)
            a_all = torch.zeros(t * g, d)
            for m, l_, a in parts:   # split order
                c = torch.exp(m - m_all)
                l_all = l_all + l_ * c
                a_all = a_all + a * c[:, None]
            o = a_all / l_all.clamp(min=1e-30)[:, None]
            out[bi, :, h * g:(h + 1) * g] = o.reshape(t, g, d)
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 9, 32])
@pytest.mark.parametrize("t,hq,hkv", [(1, 8, 2), (2, 4, 2), (4, 2, 2)])
def test_split_merge_order_matches_plain_and_pallas(splits, t, hq, hkv):
    # Lengths on and around tile and chunk edges, a row with no cached
    # key beside one that fills the cache; f32 throughout.
    max_len = 256
    lens = np.array([0, 63, 64, 65, 127, 128, 200, max_len - t], np.int32)
    q, k, v = _inputs(splits * 10 + t, len(lens), t, hq, hkv, 128, max_len)
    got = _split_emulation(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), lens, splits)
    plain = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, lens), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("splits", [3, 7])
def test_split_merge_order_at_a_ragged_max_len(splits):
    # max_len 300 is no multiple of a tile or of any chunk: the last
    # split's chunk ends at live, inside a tile.
    lens = np.array([0, 1, 150, 298, 299], np.int32)
    q, k, v = _inputs(splits, len(lens), 1, 8, 2, 64, 300)
    got = _split_emulation(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), lens, splits)
    want = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
