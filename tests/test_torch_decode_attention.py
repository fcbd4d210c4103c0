"""Port of the decode-attention kernel: the plain PyTorch version held
against the JAX package's pallas kernel (interpret mode) on the CPU. The
CUDA kernel is held against the plain version in
test_torch_kernels_cuda.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu.ops.decode_attention import (
    decode_attention as j_decode_attention,
)
from container_engine_accelerators_tpu.ops.decode_attention import (
    paged_decode_attention as j_paged_decode_attention,
)
from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.ops import (
    decode_attention as da,
)
from container_engine_accelerators_tpu_torch.ops import quant
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


# ----------------------------------------------- the kernel's prefill walk

def _contiguous_tiles(k, v, ks=None, vs=None):
    """The loader's addressing of a contiguous cache: tile(b, h, k0, n)
    gives keys k0 .. k0 + n - 1 of row b, KV head h: K and V payload
    rows, and their scales or None."""
    def tile(b, h, k0, n):
        pos = slice(k0, k0 + n)
        if ks is None:
            return k[b, pos, h], v[b, pos, h], None, None
        return k[b, pos, h], v[b, pos, h], ks[b, h, pos], vs[b, h, pos]
    return tile


def _paged_tiles(k_pool, v_pool, tables, ks=None, vs=None):
    """The loader's addressing of a page pool: where a tile lies in one
    page (page a multiple of KEY_TILE), one clamped table entry for the
    whole tile and its keys consecutive from k0 % page; else each key's
    own entry."""
    n_pages, page = k_pool.shape[:2]

    def tile(b, h, k0, n):
        pos = torch.arange(k0, k0 + n)
        if page % da.KEY_TILE == 0:
            rows = tables[b, k0 // page].long().clamp(0, n_pages - 1)
            rows = rows.expand(n)
        else:
            rows = tables[b, pos // page].long().clamp(0, n_pages - 1)
        offs = pos % page
        if ks is None:
            return k_pool[rows, offs, h], v_pool[rows, offs, h], None, None
        return (k_pool[rows, offs, h], v_pool[rows, offs, h],
                ks[rows, h, offs], vs[rows, h, offs])
    return tile


def _prefill_emulation(q, lens, hkv, max_len, tile, int4=False):
    """The kernel's prefill order in plain f32 torch, over the keys that
    `tile` addresses. Per (batch row, KV head), rows r = token r // G,
    head r % G come in blocks of PREFILL_ROWS, 16 a warp; a block walks
    tiles of KEY_TILE keys up to its last visible key, k_end =
    min(live, cache_len + its last token + 1), and reads nothing at or
    past it (zero-filled). A warp skips a tile past its last query; a
    tile wholly at or below the warp's first query and before k_end runs
    unmasked, any other masks pos <= qpos and pos < k_end. The online
    softmax runs in log2 units (scores times scale * log2 e, k's scale on
    S's column), and P times v's scale enters P.V as two bf16 terms, its
    bf16 and the bf16 of what that left out, while l adds the f32 p.
    Quantized payloads enter as their integers."""
    b, t, hq, d = q.shape
    g = hq // hkv
    n_rows = t * g
    scale2 = d ** -0.5 * math.log2(math.e)

    def bf16(x):
        return x.bfloat16().float()

    def payload(x):
        return (quant.unpack_int4(x) if int4 else x).float()

    out = torch.zeros(b, t, hq, d)
    for bi in range(b):
        cache_len = int(lens[bi])
        live = min(cache_len + t, max_len)
        for h in range(hkv):
            rows = q[bi, :, h * g:(h + 1) * g].reshape(n_rows, d).float()
            o_rows = torch.zeros(n_rows, d)
            for row0 in range(0, n_rows, da.PREFILL_ROWS):
                n = min(da.PREFILL_ROWS, n_rows - row0)
                k_end = min(live, cache_len + (row0 + n - 1) // g + 1)
                qpos = cache_len + (row0 + torch.arange(n)) // g
                m = torch.full((n,), -1e30)
                l_ = torch.zeros(n)
                acc = torch.zeros(n, d)
                for k0 in range(0, k_end, da.KEY_TILE):
                    pos = torch.arange(k0, k0 + da.KEY_TILE)
                    n_read = min(da.KEY_TILE, k_end - k0)
                    kr, vr, ksr, vsr = tile(bi, h, k0, n_read)
                    kt = torch.zeros(da.KEY_TILE, d)
                    vt = torch.zeros(da.KEY_TILE, d)
                    kt[:n_read], vt[:n_read] = payload(kr), payload(vr)
                    col = torch.full((da.KEY_TILE,), scale2)
                    v_sc = torch.ones(da.KEY_TILE)
                    if ksr is not None:
                        col[:n_read] *= ksr
                        col[n_read:] = 0.0
                        v_sc[:n_read], v_sc[n_read:] = vsr, 0.0
                    for w0 in range(0, n, 16):    # the block's warps
                        wq = qpos[w0:w0 + 16]
                        if k0 > int(wq[-1]):
                            continue
                        ws = slice(w0, w0 + 16)
                        s = (rows[row0 + w0:row0 + w0 + 16] @ kt.T) * col
                        ok = torch.ones_like(s, dtype=torch.bool)
                        if not (k0 + da.KEY_TILE <= k_end
                                and k0 + da.KEY_TILE - 1 <= int(wq[0])):
                            ok = ((pos[None, :] < k_end)
                                  & (pos[None, :] <= wq[:, None]))
                            s = s.masked_fill(~ok, -1e30)
                        m_new = torch.maximum(m[ws], s.amax(-1))
                        alpha = torch.exp2(m[ws] - m_new)
                        p = torch.where(ok, torch.exp2(s - m_new[:, None]),
                                        0.0)
                        l_[ws] = l_[ws] * alpha + p.sum(-1)
                        pv = p * v_sc
                        hi = bf16(pv)
                        lo = bf16(pv - hi)
                        acc[ws] = acc[ws] * alpha[:, None] + hi @ vt + lo @ vt
                        m[ws] = m_new
                o_rows[row0:row0 + n] = acc / l_.clamp(min=1e-30)[:, None]
            out[bi, :, h * g:(h + 1) * g] = o_rows.reshape(t, g, d)
    return out


def _jquantized(rs, mode, shape):
    """A random f32 cache of `shape` [..., S, Hkv, D] through the JAX
    quantizer (or as it is, bf16 mode): (payload, scales or None) as
    numpy."""
    x = rs.randn(*shape).astype(np.float32)
    if mode == "bf16":
        return x, None
    quantize = (jquant.quantize_kv_int4 if mode == "int4"
                else jquant.quantize_kv)
    return tuple(np.array(a) for a in quantize(jnp.asarray(x)))


def _poisoned(x, dead, fill):
    """A copy of x holding `fill` where `dead` ([..., S] over x's leading
    dims) is true."""
    x = torch.from_numpy(x).clone()
    x[torch.from_numpy(dead)] = fill
    return x


def _poisoned_scales(x, dead):
    """A copy of head-major scales [..., Hkv, S] holding NaN where `dead`
    ([..., S]) is true."""
    x = torch.from_numpy(x).clone().transpose(-1, -2)
    x[torch.from_numpy(dead)] = float("nan")
    return x.transpose(-1, -2)


def _check_walk(got, q, k, v, lens, ks, vs, int4, want):
    """The emulation's output against the plain version and the Pallas
    kernel's (`want`), within 1e-5 (f32 inputs; P's two bf16 terms keep
    16 significant bits)."""
    tq = torch.from_numpy
    scales = () if ks is None else (tq(ks), tq(vs))
    plain = decode_attention_plain(tq(q), tq(k), tq(v), tq(lens), *scales,
                                   int4=int4)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("t", [2, 17, 128])
def test_prefill_walk_matches_plain_and_pallas(mode, g, t):
    # Lengths on and around tile edges, so a block's diagonal crosses a
    # tile partway. The emulation reads a cache poisoned at and past
    # `live` (NaN, or extreme integers and NaN scales); the plain version
    # and JAX's Pallas kernel (interpret mode) read the clean one.
    hkv, d, max_len = 2, 128, 256
    lens = np.array([0, 63, 64, 65, max_len - t], np.int32)
    int4 = mode == "int4"
    rs = np.random.RandomState(100 * g + t + len(mode))
    q = rs.randn(len(lens), t, g * hkv, d).astype(np.float32)
    (k, ks), (v, vs) = (_jquantized(rs, mode, (len(lens), max_len, hkv, d))
                        for _ in range(2))
    want = np.asarray(jax.device_get(j_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, lens)), interpret=True,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), int4=int4)))
    dead = np.arange(max_len)[None, :] >= (lens + t)[:, None]   # [B, S]
    fills = (float("nan"),) * 2 if ks is None else (127, -128)
    kp, vp = (_poisoned(x, dead, fill) for x, fill in zip((k, v), fills))
    scales = (None, None) if ks is None else (
        _poisoned_scales(ks, dead), _poisoned_scales(vs, dead))
    got = _prefill_emulation(torch.from_numpy(q), lens, hkv, max_len,
                             _contiguous_tiles(kp, vp, *scales), int4)
    _check_walk(got, q, k, v, lens, ks, vs, int4, want)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("page", [16, 48, 128])
@pytest.mark.parametrize("g,t", [(1, 17), (4, 2), (4, 128), (8, 17)])
def test_paged_prefill_walk_matches_plain_and_pallas(mode, page, g, t):
    # The walk over a page pool as the loader addresses it: one table
    # entry a tile at page 128, each key its own at pages 16 (four pages
    # a tile) and 48 (pages across tile edges). Live pages sit at
    # shuffled pool rows and entries past them are out of range; the
    # emulation's pool holds NaN (or extreme integers and NaN scales)
    # wherever no row's live key is, the plain version's and the Pallas
    # kernel's the clean random values.
    hkv, d = 2, 128
    lens = np.array([0, 63, 64, 65, 200 - t], np.int32)
    int4 = mode == "int4"
    rs = np.random.RandomState(1000 + page + 10 * g + t + len(mode))
    live_pages = -(-(lens + t) // page)
    n_pages, max_pages = int(live_pages.sum()) + 3, int(live_pages.max()) + 2
    tables = rs.randint(-5, n_pages + 5, size=(len(lens), max_pages))
    tables = tables.astype(np.int32)
    perm = rs.permutation(np.arange(1, n_pages))
    dead = np.ones((n_pages, page), bool)
    for row, (n, pages) in enumerate(zip(lens + t, live_pages)):
        tables[row, :pages], perm = perm[:pages], perm[pages:]
        for p in range(n):
            dead[tables[row, p // page], p % page] = False
    q = rs.randn(len(lens), t, g * hkv, d).astype(np.float32)
    (k, ks), (v, vs) = (_jquantized(rs, mode, (n_pages, page, hkv, d))
                        for _ in range(2))
    want = np.asarray(jax.device_get(j_paged_decode_attention(
        *(jnp.asarray(x) for x in (q, k, v, lens, tables)), interpret=True,
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), int4=int4)))
    fills = (float("nan"),) * 2 if ks is None else (127, -128)
    kp, vp = (_poisoned(x, dead, fill) for x, fill in zip((k, v), fills))
    scales = (None, None) if ks is None else (
        _poisoned_scales(ks, dead), _poisoned_scales(vs, dead))
    got = _prefill_emulation(
        torch.from_numpy(q), lens, hkv, max_pages * page,
        _paged_tiles(kp, vp, torch.from_numpy(tables), *scales), int4)
    # The plain version over the clean pools, gathered contiguous.
    rows = np.clip(tables, 0, n_pages - 1)
    flat = [x[rows].reshape(len(lens), max_pages * page, hkv, -1)
            for x in (k, v)]
    flat_scales = [None, None] if ks is None else [
        np.ascontiguousarray(x[rows].transpose(0, 2, 1, 3).reshape(
            len(lens), hkv, max_pages * page)) for x in (ks, vs)]
    _check_walk(got, q, *flat, lens, *flat_scales, int4, want)


class _PrefillRecorder:
    """Stands in for the kernel library: records each entry's name and
    its (splits, part, tickets) arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            # (..., scale, splits, part, tickets, stream)
            self.calls.append((name, *args[-4:-1]))
            return 0
        return entry


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("paged", [False, True])
def test_wrapper_gives_prefill_one_split_and_no_workspace(monkeypatch, mode,
                                                          paged):
    # Past DECODE_ROWS query rows a KV head the wrapper calls the entry
    # of the cache's mode with one split and null workspace pointers
    # (the prefill body walks a row block's keys alone), for K1 and K3;
    # at exactly DECODE_ROWS it still takes the decode split.
    lib = _PrefillRecorder()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(da, "_tickets", {})
    b, hq, hkv, d, page, max_pages = 2, 8, 2, 64, 64, 4
    d_store = d // 2 if mode == "int4" else d
    dtype = torch.bfloat16 if mode == "bf16" else torch.int8
    n = page * max_pages if not paged else 3
    shape = (b, n, hkv, d_store) if not paged else (n, page, hkv, d_store)
    cache = torch.zeros(shape, dtype=dtype)
    scales = ()
    if mode != "bf16":
        s_shape = (b, hkv, n) if not paged else (n, hkv, page)
        sc = torch.ones(s_shape)
        scales = (sc, sc, mode == "int4")
    tables = torch.zeros(b, max_pages, dtype=torch.int32)
    for t in (5, 2, 1):   # 20 and 8 rows: prefill; 4: decode
        q = torch.zeros(b, t, hq, d, dtype=torch.bfloat16)
        if paged:
            da.paged_decode_attention_cuda(q, cache, cache, 0, tables,
                                           *scales)
        else:
            decode_attention_cuda(q, cache, cache, 0, *scales)
    entry = ("paged_decode_attention" if paged else "decode_attention"
             ) + f"_{mode}"
    decode_splits = split_plan(b, hkv, 4, page * max_pages, 132)
    assert decode_splits > 1
    assert [c[:2] for c in lib.calls] == [(entry, 1), (entry, 1),
                                          (entry, decode_splits)]
    assert [c[2:] for c in lib.calls[:2]] == [(0, 0)] * 2
    assert all(c[2] and c[3] for c in lib.calls[2:])
