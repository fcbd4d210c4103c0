"""The port's CUDA kernels held against their plain PyTorch versions on
the card. Every test is marked `cuda` and skips where
torch.cuda.is_available() is False. This file imports no JAX, so it runs
on a GPU machine without it:

  python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import re

import pytest
import torch

from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models.llama import (
    init_params,
    init_train_params,
    llama_tiny,
)
from container_engine_accelerators_tpu_torch.ops import flash_attention as fa
from container_engine_accelerators_tpu_torch.ops import quant
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from container_engine_accelerators_tpu_torch.training.data import (
    synthetic_batches,
)
from container_engine_accelerators_tpu_torch.training.fused_adamw import (
    FusedAdamW,
)
from container_engine_accelerators_tpu_torch.training.train import (
    make_train_step,
    to_device,
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


def _paged_case(cuda, seed, lens, t, page, hq, hkv, d, max_pages):
    """Pools with each slot's live pages at permuted rows. Every row no
    live page uses, and every position at or past a slot's `live`
    within its last page, holds NaN; table entries past the live pages
    point at NaN rows, out of range, or 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    live_pages = [-(-(n + t) // page) for n in lens]
    n_pages = sum(live_pages) + 4
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
    k_pool = torch.full((n_pages, page, hkv, d), float("nan"), device=cuda,
                        dtype=torch.bfloat16)
    v_pool = k_pool.clone()
    unused = perm[sum(live_pages):].tolist()
    tables = torch.zeros(len(lens), max_pages, dtype=torch.int32,
                         device=cuda)
    used = 0
    for i, (n, pages) in enumerate(zip(lens, live_pages)):
        rows = perm[used:used + pages]
        used += pages
        tables[i, :pages] = rows.int()
        for j in range(pages, max_pages):
            tables[i, j] = (unused[j % len(unused)], -7, n_pages + 3, 0)[j % 4]
        for j, row in enumerate(rows.tolist()):
            keys = min(page, n + t - j * page)   # live keys in this page
            for pool in (k_pool, v_pool):
                pool[row, :keys] = torch.randn(
                    keys, hkv, d, generator=gen, device=cuda).bfloat16()
    q = torch.randn(len(lens), t, hq, d, generator=gen,
                    device=cuda).bfloat16()
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k_pool, v_pool, lens, tables


@pytest.mark.parametrize("page", [16, 64, 128, 256])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", [1, 5, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 1), (8, 2), (32, 8)])
def test_paged_decode_attention_kernel_matches_plain(cuda, page, d, t, hq,
                                                     hkv):
    # K1's rule, per output row. NaN sits in every unreferenced page and
    # past `live`: the kernel reads neither, the plain version zeroes
    # what it gathers there.
    max_pages = -(-(600 + t) // page) + 1
    lens = [0, 1, page - 1, page, 600, 3 * page + 5 - t]
    lens = [max(n, 0) for n in lens]
    q, kp, vp, lens_t, tables = _paged_case(cuda, page + d + t + hq, lens, t,
                                            page, hq, hkv, d, max_pages)
    kernels.reset_launches()
    got = paged_decode_attention(q, kp, vp, lens_t, tables)
    torch.cuda.synchronize()
    assert kernels.launches["paged_decode_attention"] == 1
    want = paged_decode_attention_plain(q, kp, vp, lens_t, tables)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
    scale = want.float().abs().reshape(-1, d).amax(-1)
    assert bool((err <= ROW_RTOL * scale + ROW_ATOL).all()), (
        (err / scale).max().item())


def test_paged_kernel_equals_contiguous_kernel(cuda):
    # The same keys, paged or contiguous, give the same bits: only the
    # address of a key differs between K3 and K1.
    t, page, hq, hkv, d, max_pages = 1, 64, 32, 8, 128, 8
    lens = [0, 63, 64, 200, 511]
    q, kp, vp, lens_t, tables = _paged_case(cuda, 1, lens, t, page, hq, hkv,
                                            d, max_pages)
    rows = tables.long().clamp(0, kp.shape[0] - 1)
    k = kp[rows].reshape(len(lens), max_pages * page, hkv, d).contiguous()
    v = vp[rows].reshape(len(lens), max_pages * page, hkv, d).contiguous()
    assert torch.equal(paged_decode_attention(q, kp, vp, lens_t, tables),
                       decode_attention(q, k, v, lens_t))


def test_decode_attention_kernel_raises_on_what_it_cannot_take(cuda):
    q = torch.zeros(1, 1, 4, 96, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(1, 16, 2, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, 0)
    with pytest.raises(TypeError):
        decode_attention(q[..., :64].float(), k[..., :64].float(),
                         k[..., :64].float(), 0)


# ------------------------------------------------ K1, K3 on int8/int4 KV

def _quantized(x, mode):
    """(payload, contiguous head-major scales) of an f32 cache."""
    fn = quant.quantize_kv_int4 if mode == "int4" else quant.quantize_kv
    payload, scales = fn(x)
    return payload, scales.contiguous()


def _poison_past_live(k, v, ks, vs, live):
    """Copies of a contiguous quantized cache whose positions at or past
    each row's `live` hold extreme integers and NaN scales."""
    k, v, ks, vs = (x.clone() for x in (k, v, ks, vs))
    for row, n in enumerate(live):
        k[row, n:], v[row, n:] = 127, -128
        ks[row, :, n:], vs[row, :, n:] = float("nan"), float("nan")
    return k, v, ks, vs


def _assert_rows_close(got, want, d):
    err = (got.float() - want.float()).abs().reshape(-1, d).amax(-1)
    scale = want.float().abs().reshape(-1, d).amax(-1)
    assert bool((err <= ROW_RTOL * scale + ROW_ATOL).all()), (
        (err / scale).max().item())


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("d,hq,hkv", [(32, 4, 2), (64, 32, 8),
                                      (128, 32, 8)])
@pytest.mark.parametrize("t", [1, 7, 128])
def test_quantized_decode_attention_kernel_matches_plain(cuda, mode, d, hq,
                                                         hkv, t):
    # K1's rule, per output row, on an int8 or int4 cache; the kernel
    # reads neither payload nor scales at or past `live`, so poisoning
    # them changes no bit of its output.
    b, max_len = 3, 512
    gen = torch.Generator(device=cuda).manual_seed(d + t + len(mode))
    q = torch.randn(b, t, hq, d, generator=gen, device=cuda).bfloat16()
    k, ks = _quantized(torch.randn(b, max_len, hkv, d, generator=gen,
                                   device=cuda), mode)
    v, vs = _quantized(torch.randn(b, max_len, hkv, d, generator=gen,
                                   device=cuda), mode)
    int4 = mode == "int4"
    lens = torch.tensor([0, 129, max_len - t], dtype=torch.int32,
                        device=cuda)
    for cache_len in (lens, 64):
        live = (torch.as_tensor(cache_len).expand(b) + t).tolist()
        clean = decode_attention(q, k, v, cache_len, ks, vs, int4)
        poisoned = _poison_past_live(k, v, ks, vs, live)
        kernels.reset_launches()
        got = decode_attention(q, *poisoned[:2], cache_len, *poisoned[2:],
                               int4)
        torch.cuda.synchronize()
        assert dict(kernels.launches) == {f"decode_attention_{mode}": 1}
        assert torch.equal(got, clean)
        want = decode_attention_plain(q, *poisoned[:2], cache_len,
                                      *poisoned[2:], int4)
        assert torch.isfinite(want).all()
        _assert_rows_close(got, want, d)


def _quantized_paged_case(cuda, seed, lens, t, page, hq, hkv, d, max_pages,
                          mode):
    """_paged_case for an int8 or int4 pool: each slot's live pages at
    permuted rows; unreferenced rows, and positions at or past `live`,
    hold extreme integers and NaN scales; table entries past the live
    pages point at such rows, out of range, or 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    live_pages = [-(-(n + t) // page) for n in lens]
    n_pages = sum(live_pages) + 4
    perm = torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1
    k_pool, ks_pool = _quantized(torch.randn(
        n_pages, page, hkv, d, generator=gen, device=cuda), mode)
    v_pool, vs_pool = _quantized(torch.randn(
        n_pages, page, hkv, d, generator=gen, device=cuda), mode)
    live_at = torch.zeros(n_pages, dtype=torch.long)   # live keys per row
    unused = perm[sum(live_pages):].tolist()
    tables = torch.zeros(len(lens), max_pages, dtype=torch.int32,
                         device=cuda)
    used = 0
    for i, (n, pages) in enumerate(zip(lens, live_pages)):
        rows = perm[used:used + pages]
        used += pages
        tables[i, :pages] = rows.int()
        for j in range(pages, max_pages):
            tables[i, j] = (unused[j % len(unused)], -7, n_pages + 3, 0)[j % 4]
        for j, row in enumerate(rows.tolist()):
            live_at[row] = min(page, n + t - j * page)
    for row in range(n_pages):
        n = int(live_at[row])
        k_pool[row, n:], v_pool[row, n:] = 127, -128
        ks_pool[row, :, n:] = float("nan")
        vs_pool[row, :, n:] = float("nan")
    q = torch.randn(len(lens), t, hq, d, generator=gen,
                    device=cuda).bfloat16()
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    return q, k_pool, v_pool, ks_pool, vs_pool, lens, tables


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("page", [16, 128, 256])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 5, 128])
def test_quantized_paged_kernel_matches_plain_and_k1(cuda, mode, page, d, t):
    # K3 per output row against its plain version, with every key tile of
    # 64 straddling pages at page 16; and bit for bit against K1 on a
    # contiguous copy of the same keys and scales.
    hq, hkv = 32, 8
    max_pages = -(-(600 + t) // page) + 1
    lens = [max(n, 0) for n in (0, 1, page - 1, page, 600,
                                3 * page + 5 - t)]
    q, kp, vp, ksp, vsp, lens_t, tables = _quantized_paged_case(
        cuda, page + d + t + len(mode), lens, t, page, hq, hkv, d, max_pages,
        mode)
    int4 = mode == "int4"
    kernels.reset_launches()
    got = paged_decode_attention(q, kp, vp, lens_t, tables, ksp, vsp, int4)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {f"paged_decode_attention_{mode}": 1}
    want = paged_decode_attention_plain(q, kp, vp, lens_t, tables, ksp, vsp,
                                        int4)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    _assert_rows_close(got, want, d)
    b, max_len = len(lens), max_pages * page
    rows = tables.long().clamp(0, kp.shape[0] - 1)
    k = kp[rows].reshape(b, max_len, hkv, -1).contiguous()
    v = vp[rows].reshape(b, max_len, hkv, -1).contiguous()
    ks = ksp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
    vs = vsp[rows].transpose(1, 2).reshape(b, hkv, max_len).contiguous()
    assert torch.equal(got, decode_attention(q, k, v, lens_t, ks, vs, int4))


# ------------------------------------------ K1, K3 decode: the key split

# Lengths around the edges of the decode split at 8 rows and 8 KV heads
# (9 splits on an H100 SXM, 8 on the PCIe card): 0 cached keys beside a
# full row, one tile exactly and one key past it, nine chunks of 64
# exactly and one key more (chunks of 128), nine chunks of 128 exactly,
# four tiles.
SPLIT_EDGE_LENS = [0, 2039, 63, 64, 575, 576, 1151, 255]


def _split_case(cuda, seed, mode, page):
    """(paged?, args of the call, args of K1 on a contiguous copy of the
    same keys): contiguous at max_len 2040, no multiple of a chunk, or a
    pool at `page` holding NaN (bf16) or extreme integers and NaN scales
    wherever the kernel must not read."""
    hq, hkv, d = 32, 8, 128
    int4 = mode == "int4"
    if page is None:
        b, max_len = len(SPLIT_EDGE_LENS), 2040
        gen = torch.Generator(device=cuda).manual_seed(seed)
        q = torch.randn(b, 1, hq, d, generator=gen, device=cuda).bfloat16()
        k, v = (torch.randn(b, max_len, hkv, d, generator=gen, device=cuda)
                for _ in range(2))
        lens = torch.tensor(SPLIT_EDGE_LENS, dtype=torch.int32, device=cuda)
        if mode == "bf16":
            args = (q, k.bfloat16(), v.bfloat16(), lens)
        else:
            (k, ks), (v, vs) = _quantized(k, mode), _quantized(v, mode)
            args = (q, k, v, lens, ks, vs, int4)
        return args, args
    max_pages = -(-2040 // page)
    if mode == "bf16":
        q, kp, vp, lens, tables = _paged_case(
            cuda, seed, SPLIT_EDGE_LENS, 1, page, hq, hkv, d, max_pages)
        scales = ()
    else:
        q, kp, vp, ksp, vsp, lens, tables = _quantized_paged_case(
            cuda, seed, SPLIT_EDGE_LENS, 1, page, hq, hkv, d, max_pages,
            mode)
        scales = (ksp, vsp, int4)
    b, max_len = len(SPLIT_EDGE_LENS), max_pages * page
    rows = tables.long().clamp(0, kp.shape[0] - 1)
    k = kp[rows].reshape(b, max_len, hkv, -1).contiguous()
    v = vp[rows].reshape(b, max_len, hkv, -1).contiguous()
    flat = ()
    if scales:
        flat = tuple(x[rows].transpose(1, 2).reshape(b, hkv, max_len)
                     .contiguous() for x in scales[:2]) + (int4,)
    return (q, kp, vp, lens, tables, *scales), (q, k, v, lens, *flat)


def _ops(page):
    """(kernel op, plain version): K1 for a contiguous case, K3 paged."""
    if page is None:
        return decode_attention, decode_attention_plain
    return paged_decode_attention, paged_decode_attention_plain


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("page", [None, 16, 64, 128])
def test_decode_split_matches_plain_at_chunk_edges(cuda, mode, page):
    # The split body against its plain version at the row tolerance,
    # in every payload and both addressings (page 16: a tile spans
    # pages, each key resolves its row); two calls give the same bits,
    # and K3 the same bits as K1 on a contiguous copy of its keys.
    args, flat = _split_case(cuda, 100 + (page or 0) + len(mode), mode,
                             page)
    op, plain = _ops(page)
    name = ("paged_decode_attention" if page else "decode_attention") + (
        "" if mode == "bf16" else f"_{mode}")
    kernels.reset_launches()
    got = op(*args)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {name: 1}
    want = plain(*args)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    _assert_rows_close(got, want, 128)
    assert torch.equal(op(*args), got)
    if page:
        assert torch.equal(decode_attention(*flat), got)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("page", [None, 128])
def test_decode_split_replays_in_a_cuda_graph(cuda, mode, page):
    # One call captured after an eager warm-up, replayed after the
    # lengths change in place: the same bits as an eager call on the new
    # lengths. The split plan reads no length on the host.
    args, _ = _split_case(cuda, 7 + len(mode), mode, page)
    op, plain = _ops(page)
    lens = args[3]
    op(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op(*args)
    new = torch.tensor([2039, 0, 64, 63, 576, 575, 1, 1151],
                       dtype=torch.int32, device=cuda)
    if page:   # stay within the live pages _split_case wrote
        new = torch.minimum(new, lens)
    lens.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, op(*args))
    _assert_rows_close(out, plain(*args), 128)


# ------------------------------------------ K1, K3 prefill: the row blocks

# Cache lengths where a block's diagonal crosses a 64-key tile partway:
# none cached, one key short of a tile, a tile, one key past, a long row.
PREFILL_EDGE_LENS = [0, 63, 64, 65, 1023]


def _prefill_case(cuda, seed, mode, page, t, hq, hkv, d):
    """(args of the call, args of K1 on a contiguous copy of the same
    keys) at PREFILL_EDGE_LENS: a contiguous cache, or a pool at `page`,
    holding NaN (bf16) or extreme integers and NaN scales at and past
    each row's `live` and wherever else the kernel must not read."""
    int4 = mode == "int4"
    lens = PREFILL_EDGE_LENS
    b = len(lens)
    live = [n + t for n in lens]
    if page is None:
        max_len = max(live) + 5
        gen = torch.Generator(device=cuda).manual_seed(seed)
        q = torch.randn(b, t, hq, d, generator=gen, device=cuda).bfloat16()
        k, v = (torch.randn(b, max_len, hkv, d, generator=gen, device=cuda)
                for _ in range(2))
        lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
        if mode == "bf16":
            k, v = k.bfloat16(), v.bfloat16()
            for row, n in enumerate(live):
                k[row, n:], v[row, n:] = float("nan"), float("nan")
            args = (q, k, v, lens_t)
        else:
            (k, ks), (v, vs) = _quantized(k, mode), _quantized(v, mode)
            k, v, ks, vs = _poison_past_live(k, v, ks, vs, live)
            args = (q, k, v, lens_t, ks, vs, int4)
        return args, args
    max_pages = -(-max(live) // page) + 1
    if mode == "bf16":
        q, kp, vp, lens_t, tables = _paged_case(cuda, seed, lens, t, page,
                                                hq, hkv, d, max_pages)
        scales = ()
    else:
        q, kp, vp, ksp, vsp, lens_t, tables = _quantized_paged_case(
            cuda, seed, lens, t, page, hq, hkv, d, max_pages, mode)
        scales = (ksp, vsp, int4)
    max_len = max_pages * page
    rows = tables.long().clamp(0, kp.shape[0] - 1)
    k = kp[rows].reshape(b, max_len, hkv, -1).contiguous()
    v = vp[rows].reshape(b, max_len, hkv, -1).contiguous()
    flat = ()
    if scales:
        flat = tuple(x[rows].transpose(1, 2).reshape(b, hkv, max_len)
                     .contiguous() for x in scales[:2]) + (int4,)
    return (q, kp, vp, lens_t, tables, *scales), (q, k, v, lens_t, *flat)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("page", [None, 16, 128])
@pytest.mark.parametrize("t,hq,hkv,d", [
    (2, 32, 8, 128),    # T x G 8: just above decode's 4 rows
    (17, 32, 8, 128),   # 68 rows: a second block of 4 rows
    (5, 8, 1, 64),      # G 8, 40 rows: one block, warp 3 idle
    (33, 4, 4, 32),     # G 1
    (128, 32, 8, 128),  # the serving path's chunk width, 8 blocks
])
def test_prefill_matches_plain_at_tile_edges(cuda, mode, page, t, hq, hkv,
                                             d):
    # The prefill body against its plain version at the row tolerance, in
    # every payload and both addressings (page 16: a tile spans four
    # pages, each key resolves its row), with lengths that put the
    # diagonal across a tile partway through a block and poison past
    # `live`; two calls give the same bits, and K3 the same bits as K1
    # on a contiguous copy of its keys.
    args, flat = _prefill_case(cuda, 200 + t + (page or 0) + len(mode),
                               mode, page, t, hq, hkv, d)
    op, plain = _ops(page)
    name = ("paged_decode_attention" if page else "decode_attention") + (
        "" if mode == "bf16" else f"_{mode}")
    kernels.reset_launches()
    got = op(*args)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {name: 1}
    want = plain(*args)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    _assert_rows_close(got, want, d)
    assert torch.equal(op(*args), got)
    if page:
        assert torch.equal(decode_attention(*flat), got)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_generate_on_a_quantized_cache_goes_through_the_kernel(cuda, mode):
    cfg = llama_tiny(kv_cache_dtype=mode)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(1))
    kernels.reset_launches()
    out = decode.generate(model, prompt, cfg, 4)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {
        f"decode_attention_{mode}": 4 * cfg.n_layers}
    plain = decode.generate(model, prompt, cfg, 4, plain=True)
    assert out.shape == (2, 13)
    assert torch.equal(out[:, :10], plain[:, :10])


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_int8_kv_engines_kernel_path_matches_plain_path(cuda, kind):
    # The slot cache reaches K1 with per-slot lengths, the paged one K3;
    # at page 16 decode crosses pages.
    cfg = llama_tiny(kv_cache_dtype="int8")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    reqs = [([1, 2, 3], 20), (list(range(40, 77)), 12), ([9] * 20, 16)]
    name = {"continuous": "decode_attention_int8",
            "paged": "paged_decode_attention_int8"}[kind]
    answers = {}
    for plain in (False, True):
        if kind == "paged":
            eng = serve.PagedContinuousEngine(model, cfg, max_slots=2,
                                              max_len=128, page=16,
                                              prefill_chunk=16, plain=plain)
        else:
            eng = serve.ContinuousEngine(model, cfg, max_slots=2, max_len=128,
                                         prompt_bucket=16, prefill_chunk=16,
                                         plain=plain)
        try:
            kernels.reset_launches()
            futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
            answers[plain] = [f.result(timeout=300) for f in futs]
            launches = kernels.launches[name]
        finally:
            eng.stop()
            eng.thread.join(timeout=60)
        assert (launches > 0) == (not plain)
    assert answers[False] == answers[True]


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


def _int8_case(cuda, t, d, f, x_dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + t + d + f)
    x = torch.randn(t, d, generator=gen, device=cuda).to(x_dtype)
    qw = quant.quantize_weights(
        torch.randn(d, f, generator=gen, device=cuda) * d ** -0.5)
    return x, qw


def _assert_int8_close(got, want, x_dtype):
    # Exact int8 x x products (x as bf16 hi + lo terms for f32) summed in
    # f32 in another order: 1e-4 of max|y| in f32; one bf16 ulp (2^-8
    # relative) in bf16.
    tol = 1e-4 if x_dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * want.float().abs().max().item())


# Every token tile of the kernel and its edges (1, 7, 8, 9, 16 at decode;
# 64; 512 and 1037, a ragged last tile of 128, the wgmma body for bf16
# x), on ragged D and F: D 1000 (a ragged last stage), F 1032 and 520
# (rows 8-byte aligned, the mma.sync body at every T), F 1040 (16-byte
# rows, a ragged last column tile of either body), and w_down's D of
# 14336.
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 7, 8, 9, 16, 64, 512, 1037])
@pytest.mark.parametrize("d,f", [(1000, 1032), (4096, 520), (1000, 1040),
                                 (14336, 256)])
def test_int8_matmul_kernel_matches_plain_at_every_token_tile(cuda, x_dtype,
                                                               t, d, f):
    x, qw = _int8_case(cuda, t, d, f, x_dtype)
    kernels.reset_launches()
    got = quant.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert kernels.launches["int8_matmul"] == 1
    _assert_int8_close(got, quant.int8_matmul_plain(x, qw), x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,f", [(8, 4096, 1024), (8, 4096, 14336),
                                   (1024, 4096, 1024), (128, 4096, 14336)])
def test_int8_matmul_kernel_repeats_its_bits(cuda, x_dtype, t, d, f):
    # Split D (tickets, the last CTA merging in split order) and unsplit
    # shapes: two calls give the same bits.
    x, qw = _int8_case(cuda, t, d, f, x_dtype)
    first = quant.int8_matmul(x, qw)
    second = quant.int8_matmul(x, qw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_int8_close(first, quant.int8_matmul_plain(x, qw), x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_int8_matmul_kernel_replays_in_a_cuda_graph(cuda, x_dtype):
    # A split call captured after an eager warm-up, replayed on new x
    # written in place: the bits of an eager call on the new x.
    x, qw = _int8_case(cuda, 8, 4096, 4096, x_dtype)
    assert quant.plan(8, 4096, 4096, kernels.sm_count(cuda)).splits > 1
    quant.int8_matmul(x, qw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant.int8_matmul(x, qw)
    x.copy_(torch.randn(x.shape, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9)
                        ).to(x_dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, quant.int8_matmul(x, qw))


@pytest.mark.parametrize("t,d,f,x_dtype", [
    (8, 4096, 1024, torch.bfloat16), (8, 4096, 14336, torch.bfloat16),
    (8, 14336, 4096, torch.bfloat16), (8, 4096, 128256, torch.float32)])
def test_int8_matmul_is_one_kernel_a_call(cuda, t, d, f, x_dtype):
    # The decode shapes of a llama3_8b step: one CUDA kernel a call, the
    # split merged in the same launch.
    from torch.profiler import ProfilerActivity, profile

    x, qw = _int8_case(cuda, t, d, f, x_dtype)
    quant.int8_matmul(x, qw)   # tickets allocated, library loaded
    torch.cuda.synchronize()
    names = []
    for calls in (1, 3):   # the first profile also warms the profiler up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                quant.int8_matmul(x, qw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 3, names
    assert all("int8_mma_kernel" in name for name in names), names


def test_int8_matmul_kernel_refuses_what_it_cannot_take(cuda):
    qw = quant.quantize_weights(torch.randn(64, 32, device=cuda))
    with pytest.raises(ValueError):    # D % 8
        quant.int8_matmul(torch.randn(2, 60, device=cuda),
                          quant.quantize_weights(
                              torch.randn(60, 32, device=cuda)))
    with pytest.raises(ValueError):    # x not 16-byte aligned
        quant.int8_matmul(torch.randn(2 * 64 + 1, device=cuda)[1:].view(
            2, 64), qw)
    with pytest.raises(ValueError):    # a weight on another device
        quant.int8_matmul(torch.randn(2, 64, device=cuda),
                          quant.quantize_weights(torch.randn(64, 32)))


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


def test_paged_engine_kernel_path_matches_plain_path(cuda):
    # The same requests through the paged engine on the kernel path and
    # on the plain path, at page 16 so decode crosses pages: the same
    # greedy tokens.
    cfg = llama_tiny()
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    reqs = [([1, 2, 3], 20), (list(range(40, 77)), 12), ([9] * 20, 16)]
    answers = {}
    for plain in (False, True):
        eng = serve.PagedContinuousEngine(model, cfg, max_slots=2,
                                          max_len=128, page=16,
                                          prefill_chunk=16, plain=plain)
        try:
            kernels.reset_launches()
            futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
            answers[plain] = [f.result(timeout=300) for f in futs]
            launches = kernels.launches["paged_decode_attention"]
        finally:
            eng.stop()
            eng.thread.join(timeout=60)
        assert (launches > 0) == (not plain)
        assert eng.pages_in_use == eng.prefix_index.pages_held()
    assert answers[False] == answers[True]


# ---------------------------------------------------------- K4, K5, K6

# Flash attention, bf16 in both: the output rounds to bf16 after f32
# sums taken in another order, so an element may move by one bf16 ulp,
# at most 2^-7 of the largest |x| of its row (D values); the gradients
# round twice (ds to bf16 before its product, then the sum), so 2^-6.
# dk/dv sum the GQA group in f32 in both versions. The gradients also
# carry an absolute error: ds = p * (dp - delta) cancels where dp is
# close to delta (always, in a causal row's first query), and the two
# versions' f32 dp differ by ~1e-6 of |do||v|; so each element may also
# be off by 2^-14 of the tensor's largest |x|.
FLASH_ROW_RTOL, FLASH_GRAD_ROW_RTOL = 2 ** -7, 2 ** -6
FLASH_TENSOR_ATOL = 2 ** -14
# Where each packed sequence after the first starts, as shares of S: none
# (no segment ids); three of unequal length; seven of equal length, every
# boundary inside a 128-key tile, so that K4 skips whole key tiles before
# and after a q tile's live keys and masks the tiles that hold one.
SEGMENT_STARTS = {1: None, 3: (1 / 3, 1 / 2),
                  7: tuple(i / 7 for i in range(1, 7))}


def _flash_inputs(cuda, seed, b, s, hq, hkv, starts=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).bfloat16()

    q = fa._prescale(rnd(b, s, hq, 128))
    k, v, do = rnd(b, s, hkv, 128), rnd(b, s, hkv, 128), rnd(b, s, hq, 128)
    seg = None
    if starts is not None:
        pos = torch.arange(s, device=cuda)
        seg = sum((pos >= int(f * s)).float() for f in starts).expand(
            b, s).contiguous()
    return q, k, v, do, seg


def _rows_close(got, want, what, rtol=FLASH_GRAD_ROW_RTOL):
    err = (got.float() - want.float()).abs().reshape(-1, 128).amax(-1)
    scale = want.float().abs().reshape(-1, 128).amax(-1)
    atol = FLASH_TENSOR_ATOL * scale.max()
    assert bool((err <= rtol * scale + atol).all()), (
        what, (err / (scale + atol / rtol)).max().item())


@pytest.mark.parametrize("s", [256, 512, 2048])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1), (8, 2), (32, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_segments", [1, 3, 7])
def test_flash_kernels_match_plain(cuda, s, hq, hkv, causal, n_segments):
    b = 1 if s == 2048 else 2
    q, k, v, do, seg = _flash_inputs(cuda, s + hq, b, s, hq, hkv,
                                     SEGMENT_STARTS[n_segments])
    if n_segments == 7:
        ends = (torch.diff(seg[0]) != 0).nonzero()
        assert len(ends) == 6 and not bool((ends % 128 == 127).any())
    kernels.reset_launches()
    out, lse = fa.flash_fwd_cuda(q, k, v, seg, causal)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, seg, causal)
    _rows_close(out, out_p, "out", FLASH_ROW_RTOL)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    # The backward kernels on the plain forward's out and lse, so each
    # is held alone.
    delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, do, lse_p, delta, causal)
    _rows_close(fa.flash_bwd_dq_cuda(*args), fa.flash_bwd_dq_plain(*args),
                "dq")
    for got, want, what in zip(fa.flash_bwd_dkv_cuda(*args),
                               fa.flash_bwd_dkv_plain(*args), ("dk", "dv")):
        _rows_close(got, want, what)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                      "flash_bwd_dkv": 1}


# Segment starts for the backward's tile edges, in positions: on 64-key
# edges that are not 128-key ones; on 128-key edges; and a long first
# sequence, so that late q tiles skip whole early key tiles and early key
# tiles skip whole late q tiles.
EDGE_STARTS = {"on_64": (64, 192, 320, 960, 1600),
               "on_128": (128, 384, 1024),
               "skip_whole": (None, 64)}


def _edge_seg(cuda, layout, b, s):
    starts = [s // 2 + (x or 0) if layout == "skip_whole" else x
              for x in EDGE_STARTS[layout]]
    pos = torch.arange(s, device=cuda)
    return sum(((pos >= x).float() for x in starts if x < s),
               torch.zeros(s, device=cuda)).expand(b, s).contiguous()


def _hold_backward(q, k, v, do, seg, causal):
    out, lse = fa.flash_fwd_plain(q, k, v, seg, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, seg, do, lse, delta, causal)
    kernels.reset_launches()
    _rows_close(fa.flash_bwd_dq_cuda(*args), fa.flash_bwd_dq_plain(*args),
                "dq")
    for got, want, what in zip(fa.flash_bwd_dkv_cuda(*args),
                               fa.flash_bwd_dkv_plain(*args), ("dk", "dv")):
        _rows_close(got, want, what)
    torch.cuda.synchronize()
    assert dict(kernels.launches) == {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", sorted(EDGE_STARTS))
def test_flash_backward_matches_plain_at_tile_edges(cuda, s, hq, hkv,
                                                    causal, layout):
    # n_rep 1, 4 and 8; K5's 128-row and K6's 128-key CTAs against 64-key
    # and 64-row tiles, with segment boundaries on their edges.
    q, k, v, do, _ = _flash_inputs(cuda, s + hq + hkv, 2, s, hq, hkv)
    _hold_backward(q, k, v, do, _edge_seg(cuda, layout, 2, s), causal)


@pytest.mark.parametrize("layout", ["on_64", "skip_whole"])
def test_flash_backward_noncausal_segmented_full_length(cuda, layout):
    q, k, v, do, _ = _flash_inputs(cuda, 5, 1, 2048, 32, 8)
    seg = _edge_seg(cuda, layout, 1, 2048)
    if layout == "skip_whole":   # the walks skip whole tiles here
        assert fa.dq_key_tiles(seg[0].cpu(), 15, 2048, False) == list(
            range(17, 32))
        assert fa.dkv_q_tiles(seg[0].cpu(), 0, 2048, False) == list(
            range(16))
    _hold_backward(q, k, v, do, seg, False)


def test_flash_kernels_are_deterministic(cuda):
    q, k, v, do, seg = _flash_inputs(cuda, 1, 2, 1024, 32, 8)
    outs = []
    for _ in range(2):
        out, lse = fa.flash_fwd_cuda(q, k, v, seg, True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, seg, do, lse, delta.contiguous(), True)
        outs.append([out, lse, fa.flash_bwd_dq_cuda(*args),
                     *fa.flash_bwd_dkv_cuda(*args)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_flash_autograd_goes_through_the_kernels(cuda):
    q, k, v, do, _ = _flash_inputs(cuda, 2, 1, 512, 8, 2)
    grads = {}
    for plain in (False, True):
        args = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        kernels.reset_launches()
        out = fa.flash_attention(*args, plain=plain)
        out.backward(do)
        torch.cuda.synchronize()
        expect = {} if plain else {"flash_fwd": 1, "flash_bwd_dq": 1,
                                   "flash_bwd_dkv": 1}
        assert dict(kernels.launches) == expect
        grads[plain] = [out] + [a.grad for a in args]
    _rows_close(grads[False][0], grads[True][0], "out", FLASH_ROW_RTOL)
    for got, want, what in zip(grads[False][1:], grads[True][1:], "qkv"):
        _rows_close(got, want, f"d{what}")


def test_flash_kernels_raise_on_what_they_cannot_take(cuda):
    q, k, v, do, _ = _flash_inputs(cuda, 3, 1, 256, 4, 2)
    with pytest.raises(TypeError):
        fa.flash_fwd_cuda(q.float(), k, v, None, True)
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(q[..., :64].contiguous(), k[..., :64].contiguous(),
                          v[..., :64].contiguous(), None, True)
    with pytest.raises(ValueError):
        fa.flash_fwd_cuda(q.transpose(1, 2), k, v, None, True)
    # Every flash kernel takes S a multiple of 128.
    q, k, v, do, _ = _flash_inputs(cuda, 3, 1, 192, 4, 2)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_fwd_cuda(q, k, v, None, True)
    stats = torch.zeros((1, 4, 192), device=cuda)
    for bwd in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="multiple of 128"):
            bwd(q, k, v, None, do, stats, stats, True)
    # Segment ids at an address K4 cannot read 16 bytes at a time.
    q, k, v, _, _ = _flash_inputs(cuda, 3, 1, 256, 4, 2)
    seg = torch.zeros(257, device=cuda)[1:].view(1, 256)
    assert seg.is_contiguous() and seg.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd_cuda(q, k, v, seg, True)


def test_train_step_kernel_path_matches_plain_path(cuda):
    # head_dim 128 and S 256, so the flash kernels engage.
    cfg = llama_tiny(d_model=256, n_heads=2, n_kv_heads=1,
                     remat_policy="dots")
    batch = to_device(next(synthetic_batches(cfg.vocab_size, 2, 256)), cuda)
    runs = {}
    for plain in (False, True):
        model = init_train_params(cfg, torch.Generator(
            device=cuda).manual_seed(0), cuda)
        step = make_train_step(cfg, FusedAdamW(model.parameters(), lr=1e-3),
                               plain=plain)
        kernels.reset_launches()
        metrics = step(model, batch)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        runs[plain] = (metrics["loss"].item(),
                       [p.grad.float() for p in model.parameters()])
        if plain:
            assert launches == {}
        else:   # the forward, and its replay under 'dots' remat
            assert launches == {"flash_fwd": 2 * cfg.n_layers,
                                "flash_bwd_dq": cfg.n_layers,
                                "flash_bwd_dkv": cfg.n_layers}
    loss_k, grads_k = runs[False]
    loss_p, grads_p = runs[True]
    # bf16 activations over two layers: the kernels and their plain
    # versions part by bf16 ulps in the attention outputs.
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    for gk, gp in zip(grads_k, grads_p):
        assert (gk - gp).norm() <= 5e-2 * gp.norm()


@pytest.mark.parametrize("shape", [(4096, 4096), (1023, 4097), (3,)])
def test_scale_demo_kernel_matches_plain(cuda, shape):
    # f32 times 2 is exact: the kernel must equal x * 2.0 bit for bit,
    # on the demo's shape, on a ragged one (the last tile partial, n not
    # a multiple of 4) and on fewer values than one 16-byte load.
    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo,
        scale_demo_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda)
    kernels.reset_launches()
    got = scale_demo(x)
    torch.cuda.synchronize()
    assert kernels.launches["scale_demo"] == 1
    assert torch.equal(got, scale_demo_plain(x))
    with pytest.raises(TypeError):
        scale_demo(x.half())


@pytest.mark.parametrize("n", [1, 4, 5, 1023, 1024, 1025, 4097,
                               4096 * 4096 + 3])
def test_scale_demo_kernel_is_exact_on_ragged_sizes(cuda, n):
    # Fewer values than one chunk, one chunk +- 1, more blocks' runs than
    # the grid evenly holds, and a tail of n % 4 values past the last
    # 16-byte slot: every value x * 2.0 exactly.
    from container_engine_accelerators_tpu_torch.ops.scale_demo import (
        scale_demo,
    )

    x = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda)
    got = scale_demo(x)
    torch.cuda.synchronize()
    assert torch.equal(got, x * 2.0)


def test_oversized_scale_demo_tile_is_refused_at_compile(cuda):
    from container_engine_accelerators_tpu_torch.demo.real_fault import (
        provoke_smem_oom,
    )
    from container_engine_accelerators_tpu_torch.healthcheck import (
        health_checker,
    )

    proc = provoke_smem_oom.compile_oversized()
    assert proc.returncode != 0
    rules = {cls: pat for pat, cls in health_checker.DEFAULT_SCRAPE_RULES}
    assert re.search(rules["VMEM_OOM"], proc.stdout, re.IGNORECASE), (
        proc.stdout)
