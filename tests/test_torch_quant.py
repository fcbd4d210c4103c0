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
        for name in tllama.layer_weights(cfg):
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


# ---------------------------------------------------------------------------
# kernels/int8_matmul.cu's launch plan and walks, emulated on the CPU.

# The calls llama3_8b makes (decode, a 512 chunk, 8 x 128 prefill, every
# projection and the lm_head), ragged shapes of the card tests, and a
# product too small to split.
PLAN_CASES = [
    (8, 4096, 14336, True), (8, 4096, 128256, False), (8, 4096, 1024, True),
    (8, 14336, 4096, True), (1, 4096, 4096, True), (16, 4096, 1024, True),
    (1024, 4096, 14336, True), (1024, 4096, 1024, True),
    (1024, 4096, 128256, False), (512, 4096, 14336, True),
    (128, 14336, 4096, True), (1037, 1000, 1040, True),
    (37, 1000, 520, True), (64, 256, 1032, False), (3, 64, 4, True),
]


@pytest.mark.parametrize("sms", [132, 114])     # H100 SXM and PCIe
@pytest.mark.parametrize("t,d,f,x_bf16", PLAN_CASES)
def test_plan_covers_d_and_f_exactly(t, d, f, x_bf16, sms):
    vec = next(v for v in (16, 8, 4) if f % v == 0)
    p = quant.plan(t, d, f, sms, x_bf16, vec)
    depth, cols = quant.DEPTH[p.body], quant.COLS_PER_BLOCK[p.body]
    # D: whole stages a split, every row in exactly one split.
    assert p.d_per_split % depth == 0
    assert p.splits >= 1 and p.d_per_split * (p.splits - 1) < d
    assert d <= p.d_per_split * p.splits
    # F and T: every column and row in exactly one tile, the token tile
    # the smallest that holds t.
    assert (p.col_tiles - 1) * cols < f <= p.col_tiles * cols
    assert (p.token_tiles - 1) * p.tokens < t <= p.token_tiles * p.tokens
    smaller = [n for n in quant.TOKEN_TILES if n < p.tokens]
    assert t > 128 or not smaller or t > smaller[-1]
    # The wgmma body only for bf16 x on 16-byte rows at the largest tile.
    assert (p.body == "int8_wgmma_kernel") == (
        x_bf16 and vec == 16 and p.tokens == 128)
    # The grid fills the card, no more than needed: at most one wave of
    # one CTA an SM for wgmma; at decode about four an SM, each at least
    # two stages deep.
    tiles = p.token_tiles * p.col_tiles
    if p.body == "int8_wgmma_kernel" and p.splits > 1:
        assert tiles * p.splits <= sms
    if p.tokens <= quant.DECODE_TOKENS and p.splits > 1:
        assert tiles * p.splits < 4 * sms + tiles
        assert p.d_per_split >= 2 * depth
    # A function of the shapes and the SM count alone.
    assert quant.plan(t, d, f, sms, x_bf16, vec) == p


def test_plan_refuses_an_empty_product():
    with pytest.raises(ValueError):
        quant.plan(0, 64, 32, 132)


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm for selector nibbles below 8."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _bf16(bits: int) -> float:
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _i8_pair(w0: int, w1: int, b: int) -> tuple[float, float]:
    """The kernel's i8_pair<b>: bytes b of w0 and w1 as (low, high) bf16
    of lo - hi, both halves exact in f32 (and so in bf16)."""
    p = _byte_perm(w0, w1, b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12))
    lo = (p & 0x007F007F) | 0x43004300
    hi = (p & 0x00800080) | 0x43004300
    return tuple(_bf16((lo >> s) & 0xFFFF) - _bf16((hi >> s) & 0xFFFF)
                 for s in (0, 16))


def test_int8_pair_becomes_bf16_exactly():
    # Every int8 value in every byte slot of both words, among random
    # neighbours: the two masks under the exponent of 128 and one bf16x2
    # fma give the integer.
    rs = np.random.RandomState(0)
    for b in range(4):
        for v in range(-128, 128):
            v2 = int(rs.randint(-128, 128))
            words = []
            for val in (v, v2):
                word = int(rs.randint(0, 2 ** 32, dtype=np.uint64))
                byte = int(np.int8(val).view(np.uint8))
                words.append(word & ~(0xFF << (8 * b)) | (byte << (8 * b)))
            assert _i8_pair(*words, b) == (v, v2)


def _mma_walk(nt: int):
    """The mma.sync body's index maps over one 64-row stage of a 128-
    column tile, lane by lane: A[m-tile][row][k] -> (d, f) from a_frags,
    B[n-tile][k][col] -> (d, t) from the x fragment read, and the (t, f)
    each accumulator slot is stored to by the epilogue."""
    wf_n = 4 if nt <= 16 else 2
    mw, nw = 128 // wf_n, nt // (4 // wf_n)
    rb = mw // 8
    a, b, c = {}, {}, {}
    for warp in range(4):
        wf, wt = warp % wf_n, warp // wf_n
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            for kk in range(4):
                rows = [16 * kk + 4 * tq + r for r in range(4)]
                col0 = wf * mw + g * rb
                for j in range(mw // 16):
                    # Bytes 2j and 2j + 1 of the thread's rb columns.
                    for reg, (r0, r1, byte) in enumerate(
                            [(0, 1, 2 * j), (0, 1, 2 * j + 1),
                             (2, 3, 2 * j), (2, 3, 2 * j + 1)]):
                        row = g + 8 * (reg % 2)
                        k = 2 * tq + 8 * (reg // 2)
                        a[warp, j, kk, row, k] = (rows[r0], col0 + byte)
                        a[warp, j, kk, row, k + 1] = (rows[r1], col0 + byte)
                for n in range(nw // 8):
                    tok = wt * nw + n * 8 + g
                    for i, k in enumerate((2 * tq, 2 * tq + 1, 2 * tq + 8,
                                           2 * tq + 9)):
                        b[warp, n, kk, k, g] = (rows[i], tok)
            fc = wf * mw + g * rb
            for n in range(nw // 8):
                for e in range(2):
                    tok = wt * nw + n * 8 + 2 * tq + e
                    for q0 in range(0, rb, 4):
                        j = q0 // 2
                        for q, (jj, slot) in enumerate(
                                [(j, e), (j, 2 + e), (j + 1, e),
                                 (j + 1, 2 + e)]):
                            row = g + 8 * (slot // 2)
                            col = 2 * tq + slot % 2
                            c[warp, jj, n, row, col] = (tok, fc + q0 + q)
    return a, b, c, mw // 16, nw // 8, 4


def _wgmma_walk():
    """The wgmma body's maps for one 16-row step of D, kk = 0 (A from
    wg_a_frags, B in D's own order from the swizzled x tile read by the
    descriptor, the accumulator d[4j + e] at row 16w + g + 8(e / 2),
    column 8j + 2t + e % 2)."""
    a, b, c = {}, {}, {}
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                g, tq = lane // 4, lane % 4
                rows = [2 * tq, 2 * tq + 1, 2 * tq + 8, 2 * tq + 9]
                col0 = wg * 128 + w * 32 + 4 * g
                for h in range(2):
                    for reg, (r0, r1, byte) in enumerate(
                            [(0, 1, 2 * h), (0, 1, 2 * h + 1),
                             (2, 3, 2 * h), (2, 3, 2 * h + 1)]):
                        row = 16 * w + g + 8 * (reg % 2)
                        k = 2 * tq + 8 * (reg // 2)
                        a[wg, h, 0, row, k] = (rows[r0], col0 + byte)
                        a[wg, h, 0, row, k + 1] = (rows[r1], col0 + byte)
                for j in range(16):
                    for e in range(2):
                        tok = 8 * j + 2 * tq + e
                        vals = [(0, e), (0, 2 + e), (1, e), (1, 2 + e)]
                        for q, (h, slot) in enumerate(vals):
                            row = 16 * w + g + 8 * (slot // 2)
                            c[wg, h, 0, row, tok] = (tok, col0 + q)
    for wg in range(2):
        for h in range(2):
            for k in range(16):
                for tok in range(128):
                    b[wg, h, 0, k, tok] = (k, tok)
    return a, b, c


@pytest.mark.parametrize("nt", quant.TOKEN_TILES)
def test_mma_fragments_permute_columns_and_the_epilogue_inverts_them(nt):
    # The A operand's rows are a permutation of the tile's columns and
    # its k slots one of the stage's D rows; the x fragment must use the
    # same D row at each k, and the epilogue must store each accumulator
    # slot to the column its row stands for (the inverse permutation), so
    # the tile's y^T is exactly W^T x^T: checked on integers, in f64.
    a, b, c, n_m, n_n, warps = _mma_walk(nt)
    rs = np.random.RandomState(nt)
    w = rs.randint(-127, 128, size=(64, 128)).astype(np.float64)
    x = rs.randint(-8, 9, size=(nt, 64)).astype(np.float64)
    y = np.full((nt, 128), np.nan)
    for warp in range(warps):
        for j in range(n_m):
            for n in range(n_n):
                acc = np.zeros((16, 8))
                for kk in range(4):
                    for row in range(16):
                        for col in range(8):
                            for k in range(16):
                                d, f = a[warp, j, kk, row, k]
                                d2, t = b[warp, n, kk, k, col]
                                assert d == d2
                                acc[row, col] += w[d, f] * x[t, d]
                for row in range(16):
                    for col in range(8):
                        t, f = c[warp, j, n, row, col]
                        assert np.isnan(y[t, f])   # stored once
                        y[t, f] = acc[row, col]
    np.testing.assert_array_equal(y, x @ w)


def test_wgmma_fragments_permute_columns_and_the_epilogue_inverts_them():
    a, b, c = _wgmma_walk()
    rs = np.random.RandomState(1)
    w = rs.randint(-127, 128, size=(16, 256)).astype(np.float64)
    x = rs.randint(-8, 9, size=(128, 16)).astype(np.float64)
    y = np.full((128, 256), np.nan)
    for wg in range(2):
        for h in range(2):
            for row in range(64):
                cols = [a[wg, h, 0, row, k] for k in range(16)]
                f = cols[0][1]
                assert all(fk == f for _, fk in cols)   # one column a row
                for tok in range(128):
                    want_t, want_f = c[wg, h, 0, row, tok]
                    assert (want_t, want_f) == (tok, f)
                    assert np.isnan(y[tok, f])
                    y[tok, f] = sum(w[a[wg, h, 0, row, k][0], f]
                                    * x[tok, b[wg, h, 0, k, tok][0]]
                                    for k in range(16))
    np.testing.assert_array_equal(y, x @ w)


def _banks(addrs, width):
    """Shared-memory wavefronts a warp's reads of `width` bytes need."""
    per = 128 // width            # lanes served in one 128-byte pass
    waves = 0
    for i in range(0, len(addrs), per):
        words = {}
        for addr in addrs[i:i + per]:
            for wd in range(width // 4):
                word = addr // 4 + wd
                words.setdefault(word % 32, set()).add(word)
        waves += max(len(v) for v in words.values())
    return waves


@pytest.mark.parametrize("nt", [8, 128])
def test_mma_fragment_reads_are_bank_conflict_free(nt):
    # The weight slab: chunk ^ 2 ((row / 4) % 4), 128-byte rows; x: chunk
    # ^ 2 (row % 4) in bf16, ^ 4 (row % 2) in f32.
    wf_n = 4 if nt <= 16 else 2
    mw = 128 // wf_n
    rb = mw // 8
    for wf in range(wf_n):
        for kk in range(4):
            for r in range(4):
                addrs = []
                for lane in range(32):
                    g, tq = lane // 4, lane % 4
                    row = 16 * kk + 4 * tq + r
                    byte = wf * mw + g * rb
                    ch = (byte >> 4) ^ (((row >> 2) & 3) << 1)
                    addrs.append(row * 128 + ch * 16 + (byte & 15))
                assert _banks(addrs, rb) == rb // 4   # a pass a 128 B
    for kk in range(4):
        bf, f32 = [], []
        for lane in range(32):
            g, tq = lane // 4, lane % 4
            byte = 32 * kk + 8 * tq
            bf.append(g * 128 + (((byte >> 4) ^ ((g & 3) << 1)) << 4)
                      + (byte & 15))
            f32.append(g * 256 + (((4 * kk + tq) ^ ((g & 1) << 2)) << 4))
        assert _banks(bf, 8) == 2      # 256 bytes: two passes, no more
        assert _banks(f32, 16) == 4    # 512 bytes: four passes


def test_wgmma_fragment_reads_are_bank_conflict_free():
    # 256-byte weight rows, chunk ^ 2 ((row / 2) % 4): rows 2t, 2t + 1,
    # 2t + 8, 2t + 9 of a step and a warp's 8 column groups.
    for wg in range(2):
        for w in range(4):
            for kk in range(8):
                for r in range(4):
                    addrs = []
                    for lane in range(32):
                        g, tq = lane // 4, lane % 4
                        row = 16 * kk + 2 * tq + (r & 1) + 8 * (r >> 1)
                        byte = wg * 128 + w * 32 + 4 * g
                        ch = (byte >> 4) ^ (((row >> 1) & 3) << 1)
                        addrs.append(row * 256 + ch * 16 + (byte & 15))
                    assert _banks(addrs, 4) == 1


def test_f32_x_as_bf16_hi_lo_within_1e4_at_lm_head_width():
    # The kernel's route for f32 x (the lm_head): hi = bf16(x), lo =
    # bf16(x - hi), two bf16 products on the same int8 weight, f32 sums;
    # within 1e-4 of max|y| of int8_matmul_plain at D 4096, where bf16(x)
    # alone is not.
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4096, generator=g)
    qw = quant.quantize_weights(torch.randn(4096, 8192, generator=g)
                                * 4096 ** -0.5)
    want = quant.int8_matmul_plain(x, qw)
    q = qw.values.float()
    hi = x.bfloat16()
    lo = (x - hi.float()).bfloat16()
    got = (hi.float() @ q + lo.float() @ q) * qw.scales
    bf16_only = (hi.float() @ q) * qw.scales
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    assert (bf16_only - want).abs().max() > 1e-4 * scale


@pytest.mark.parametrize("d,f,ptr,contiguous,want", [
    (4096, 14336, 0, True, None),          # every llama3_8b projection
    (4096, 128256, 512, True, None),       # the lm_head
    (64, 32, 4, True, None),               # 4-byte rows: the kernel's
    (1001, 1003, 0, True, (1008, 1008)),   # odd D and F
    (64, 30, 0, True, (64, 32)),           # F % 4
    (60, 32, 0, True, (64, 32)),           # D % 8
    (64, 32, 1, True, (64, 32)),           # rows off a 4-byte boundary
    (64, 32, 0, False, (64, 32)),          # a strided weight
])
def test_pad_plan_pads_only_what_the_kernel_cannot_take(d, f, ptr,
                                                        contiguous, want):
    assert quant.pad_plan(d, f, ptr, contiguous) == want


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d,f", [(8, 1001, 1003), (512, 1001, 1003),
                                   (3, 60, 30)])
def test_padded_operands_give_the_same_product(x_dtype, t, d, f):
    # The wrapper's padding on the CPU: the padded weight and x through
    # the plain version, sliced back, give the unpadded product (the zero
    # rows and columns add exact zeros; the CPU's matmul may block the
    # longer contraction in another order: 1e-5 of max|y| in f32, one
    # bf16 ulp in bf16). The padded copy is made once per QuantWeight and
    # remade when its values change.
    gen = torch.Generator().manual_seed(t + d + f)
    x = torch.randn(t, d, generator=gen).to(x_dtype)
    qw = quant.quantize_weights(torch.randn(d, f, generator=gen))
    d_k, f_k = quant.pad_plan(d, f, qw.values.data_ptr())
    w_k, s_k = quant._padded_operands(qw, d_k, f_k)
    assert w_k.shape == (d_k, f_k) and s_k.shape == (f_k,)
    assert w_k.data_ptr() % 16 == 0 and f_k % 16 == 0 and d_k % 8 == 0
    assert quant._padded_operands(qw, d_k, f_k)[0] is w_k
    x_k = torch.nn.functional.pad(x, (0, d_k - d))
    got = quant.int8_matmul_plain(x_k, quant.QuantWeight(w_k, s_k))[:, :f]
    want = quant.int8_matmul_plain(x, qw)
    tol = 1e-5 if x_dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * want.float().abs().max().item())
    qw.values.mul_(-1)
    w_new, _ = quant._padded_operands(qw, d_k, f_k)
    assert w_new is not w_k and torch.equal(w_new[:d, :f], qw.values)
