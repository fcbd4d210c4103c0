"""GQA attention over the KV cache for the decode path: a contiguous
cache (`decode_attention`, K1) or a page pool (`paged_decode_attention`,
K3), each over a bf16, int8 or int4 cache.

Each dispatches on the tensors' device: CUDA launches the hand-written
kernel (kernels/decode_attention.cu), CPU runs the `*_plain` version, the
same function in plain PyTorch. There is no other route: a shape or
dtype the kernel cannot take raises.

The function is the JAX package's pallas kernel's: q [B, T, Hq, D] holds
T new queries at absolute positions [cache_len, cache_len + T); the
caches [B, max_len, Hkv, D] already hold the new tokens. Query t sees
key positions p < cache_len + T with p <= cache_len + t. Scores, softmax
and p.v are f32; the output is q.dtype. cache_len is an int, a 0-d
tensor or a [B] tensor.

k_scales/v_scales ([B, Hkv, max_len] f32, ops/quant.quantize_kv's
head-major layout) mark an int8 cache: key p of head h is
float(k[b, p, h]) * k_scales[b, h, p], dequantized in f32 as the pallas
body does. `int4` marks an int8 cache of width D/2 holding two nibbles a
byte (quantize_kv_int4's split-half layout), with the same scales.

The paged form reads the same logical cache through a block table:
pools [n_pages, page, Hkv, D], tables [B, max_pages] int32, so logical
position p of row b is pool row tables[b, p // page] (clamped to
[0, n_pages - 1]), offset p % page, and max_len = max_pages * page.
Scale pools [n_pages, Hkv, page] go through the same tables. Table
entries past a row's live pages may be garbage.

The TPU kernel's VMEM gate that sent long prefills elsewhere does not
carry over: the CUDA kernel serves every prefill length.

Decode (T * Hq/Hkv <= DECODE_ROWS query rows per KV head) splits each
row's key range across CTAs (`split_plan`); each CTA takes one chunk,
ceil(live / splits) keys rounded up to KEY_TILE, and the last to finish
merges the partials in split order, so a call is still one launch,
reads no length on the host, and gives the same bits every time. The
wrapper allocates the partials' workspace per call and keeps one ticket
counter per (row, KV head) per device, which the kernel leaves at zero:
calls on one device must not run on two streams at once.

Prefill (more rows) runs one CTA per block of PREFILL_ROWS query rows of
a (KV head, batch row), the blocks with the most keys first; each walks
its keys in KEY_TILE tiles up to its last visible key, with both
products on the tensor cores and int8/int4 tiles unpacked to bf16 once a
tile. Tiles wholly visible to a warp's rows run unmasked. No split, no
workspace: the output repeats its bits, and the paged form gives the
contiguous form's bits on the same keys.
"""

from __future__ import annotations

import threading

import torch

from container_engine_accelerators_tpu_torch import kernels
from container_engine_accelerators_tpu_torch.ops.quant import (
    dequantize_kv,
    dequantize_kv_int4,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
DECODE_ROWS = 4        # query rows a decode CTA holds (kDecodeRows)
PREFILL_ROWS = 64      # query rows a prefill CTA holds (kPrefillRows)
KEY_TILE = 64          # keys per tile (kBlockK)
MAX_SPLITS = 32
SPLIT_CTAS_PER_SM = 4  # decode CTAs the split aims at, per SM

# device -> int32 ticket counters, zero between calls (the kernel resets
# them); persistent, so a captured CUDA graph keeps its pointer.
_tickets: dict = {}
_tickets_lock = threading.Lock()


def split_plan(b: int, hkv: int, n_rows: int, max_len: int,
               sm_count: int) -> int:
    """Key-range splits per (batch row, KV head): 1 for prefill (more
    than DECODE_ROWS query rows per KV head, which fills the card with
    row blocks); for decode, enough splits for SPLIT_CTAS_PER_SM CTAs a
    SM, at most one per tile of max_len and MAX_SPLITS. A function of the
    shapes and the SM count, never of the lengths."""
    if n_rows > DECODE_ROWS:
        return 1
    want = -(-SPLIT_CTAS_PER_SM * sm_count // (b * hkv))
    return max(1, min(want, MAX_SPLITS, -(-max_len // KEY_TILE)))


def _workspace(device: torch.device, b: int, hkv: int, d: int,
               splits: int) -> tuple:
    """(partials, tickets) for the kernel, None for one split. The
    partials are [B, Hkv, splits, DECODE_ROWS, D + 2] f32, fresh per call
    (the caller holds them over the launch; the caching allocator reuses
    them only after it, in stream order); the tickets persist per
    device."""
    if splits == 1:
        return None, None
    part = torch.empty(b * hkv * splits * DECODE_ROWS * (d + 2),
                       dtype=torch.float32, device=device)
    with _tickets_lock:
        tickets = _tickets.get(device)
        if tickets is None or tickets.numel() < b * hkv:
            tickets = torch.zeros(b * hkv, dtype=torch.int32, device=device)
            _tickets[device] = tickets
    return part, tickets


def _ptrs(*tensors) -> tuple:
    return tuple(0 if x is None else x.data_ptr() for x in tensors)


def _lengths(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """cache_len as a contiguous [B] int32 tensor on `device`."""
    if isinstance(cache_len, int):
        return torch.full((b,), cache_len, dtype=torch.int32, device=device)
    lens = torch.as_tensor(cache_len).to(device=device, dtype=torch.int32)
    if lens.ndim == 0:
        lens = lens.expand(b)
    if lens.shape != (b,):
        raise ValueError(f"cache_len must be a scalar or [{b}], "
                         f"got shape {tuple(lens.shape)}")
    return lens.contiguous()


def _mode(k_scales, int4: bool) -> str:
    """'bf16', 'int8' or 'int4': the cache mode, which names the kernel
    entry and its launch count."""
    if k_scales is None:
        return "bf16"
    return "int4" if int4 else "int8"


def _count_name(base: str, mode: str) -> str:
    return base if mode == "bf16" else f"{base}_{mode}"


def _check_scales(k_scales, v_scales, int4: bool, want: tuple) -> None:
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if k_scales is None:
        if int4:
            raise ValueError("an int4 cache needs its k/v scales")
        return
    for arg, x in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(x.shape) != want:
            raise ValueError(f"{arg} must be {list(want)}, got "
                             f"{list(x.shape)}")


def _check_shapes(q, k_cache, v_cache, k_scales=None, v_scales=None,
                  int4: bool = False):
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q [B,T,Hq,D] and k/v [B,max_len,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    b, t, hq, d = q.shape
    d_store = d // 2 if int4 else d
    if (k_cache.shape[0] != b or k_cache.shape[3] != d_store
            or hq % k_cache.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}"
                         + (" (int4: D/2 bytes a row)" if int4 else ""))
    _check_scales(k_scales, v_scales, int4,
                  (b, k_cache.shape[2], k_cache.shape[1]))


def _dequantized(cache: torch.Tensor, scales, int4: bool) -> torch.Tensor:
    """The cache in f32: a bf16 cache cast, an int8 or int4 one times
    its head-major scales."""
    if scales is None:
        return cache.float()
    return (dequantize_kv_int4 if int4 else dequantize_kv)(cache, scales)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len,
                           k_scales=None, v_scales=None,
                           int4: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path, and the
    reference the kernel is held against on the card)."""
    _check_shapes(q, k_cache, v_cache, k_scales, v_scales, int4)
    b, t, hq, d = q.shape
    max_len, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    lens = _lengths(cache_len, b, q.device)
    live = (lens + t).clamp(max=max_len)
    key_pos = torch.arange(max_len, device=q.device)
    t_idx = torch.arange(t, device=q.device)
    valid = ((key_pos[None, None, :] < live[:, None, None])
             & (key_pos[None, None, :]
                <= lens[:, None, None] + t_idx[None, :, None]))  # [B,T,S]
    dead = key_pos[None, :] >= live[:, None]                      # [B,S]
    # Dead positions are zeroed: their probabilities are 0, but 0 * NaN
    # is NaN and a reused cache makes no promise about them (nor about
    # their scales).
    k = _dequantized(k_cache, k_scales, int4).masked_fill(
        dead[:, :, None, None], 0.0)
    v = _dequantized(v_cache, v_scales, int4).masked_fill(
        dead[:, :, None, None], 0.0)
    qg = q.float().reshape(b, t, hkv, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k) * d ** -0.5
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(b, t, hq, d).to(q.dtype)


def _check_kernel_inputs(name: str, q, k_cache, v_cache, k_scales,
                         v_scales) -> torch.Tensor:
    """Raise on what the kernel cannot take; returns q contiguous."""
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    payload = torch.bfloat16 if k_scales is None else torch.int8
    for arg, x, dtype in (("q", q, torch.bfloat16), ("k", k_cache, payload),
                          ("v", v_cache, payload)):
        if x.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype} {arg}, got "
                            f"{x.dtype}")
    tensors = [k_cache, v_cache]
    if k_scales is not None:
        for arg, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if x.dtype != torch.float32:
                raise TypeError(f"{name} kernel takes f32 {arg}, got "
                                f"{x.dtype}")
        tensors += [k_scales, v_scales]
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"a cache tensor on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous caches and "
                             "scales")
    q = q.contiguous()
    # Payload rows (D bf16, D int8 or D/2 int4 bytes: a multiple of 16 at
    # every head dim taken) come in with 16-byte loads.
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError(f"{name} kernel takes 16-byte aligned tensors")
    return q


def _scale_ptrs(k_scales, v_scales) -> tuple:
    if k_scales is None:
        return ()
    return k_scales.data_ptr(), v_scales.data_ptr()


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len,
                          k_scales=None, v_scales=None,
                          int4: bool = False) -> torch.Tensor:
    """Launch kernels/decode_attention.cu on CUDA tensors: the bf16,
    int8 or int4 entry, as the cache is."""
    _check_shapes(q, k_cache, v_cache, k_scales, v_scales, int4)
    b, t, hq, d = q.shape
    max_len, hkv = k_cache.shape[1], k_cache.shape[2]
    q = _check_kernel_inputs("decode_attention", q, k_cache, v_cache,
                             k_scales, v_scales)
    mode = _mode(k_scales, int4)
    lens = _lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    splits = split_plan(b, hkv, t * (hq // hkv), max_len,
                        kernels.sm_count(q.device))
    workspace = _workspace(q.device, b, hkv, d, splits)
    entry = getattr(kernels.load(), f"decode_attention_{mode}")
    err = entry(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        *_scale_ptrs(k_scales, v_scales), lens.data_ptr(), out.data_ptr(),
        b, t, hq, hkv, d, max_len, d ** -0.5, splits, *_ptrs(*workspace),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_count_name("decode_attention", mode), err)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, k_scales=None,
                     v_scales=None, int4: bool = False) -> torch.Tensor:
    """[B, T, Hq, D] attention output; see the module docstring."""
    args = (q, k_cache, v_cache, cache_len, k_scales, v_scales, int4)
    if q.device.type == "cuda":
        return decode_attention_cuda(*args)
    if q.device.type == "cpu":
        return decode_attention_plain(*args)
    raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")


def _check_paged_shapes(q, k_pool, v_pool, tables, k_scales=None,
                        v_scales=None, int4: bool = False):
    if (q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape
            or tables.ndim != 2):
        raise ValueError(
            f"want q [B,T,Hq,D], pools [n_pages,page,Hkv,D] and tables "
            f"[B,max_pages], got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}, {tuple(tables.shape)}")
    b, t, hq, d = q.shape
    n_pages, page, hkv, d_store = k_pool.shape
    if (tables.shape[0] != b or d_store != (d // 2 if int4 else d)
            or hq % hkv):
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} and tables "
                         f"{tuple(tables.shape)}"
                         + (" (int4: D/2 bytes a row)" if int4 else ""))
    _check_scales(k_scales, v_scales, int4, (n_pages, hkv, page))


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, cache_len,
                                 tables: torch.Tensor, k_scales=None,
                                 v_scales=None,
                                 int4: bool = False) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather each row's
    pages, and their scale pages, through its clamped table into a
    contiguous cache, then `decode_attention_plain` (the JAX package's
    off-TPU path)."""
    _check_paged_shapes(q, k_pool, v_pool, tables, k_scales, v_scales, int4)
    b, max_pages = tables.shape
    n_pages, page, hkv, d_store = k_pool.shape
    rows = tables.long().clamp(0, n_pages - 1)
    k = k_pool[rows].reshape(b, max_pages * page, hkv, d_store)
    v = v_pool[rows].reshape(b, max_pages * page, hkv, d_store)
    ks = vs = None
    if k_scales is not None:
        ks = k_scales[rows].transpose(1, 2).reshape(b, hkv, max_pages * page)
        vs = v_scales[rows].transpose(1, 2).reshape(b, hkv, max_pages * page)
    return decode_attention_plain(q, k, v, cache_len, ks, vs, int4)


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, cache_len,
                                tables: torch.Tensor, k_scales=None,
                                v_scales=None,
                                int4: bool = False) -> torch.Tensor:
    """Launch the paged entry of kernels/decode_attention.cu (bf16, int8
    or int4, as the pools are) on CUDA tensors."""
    _check_paged_shapes(q, k_pool, v_pool, tables, k_scales, v_scales, int4)
    b, t, hq, d = q.shape
    n_pages, page, hkv, _ = k_pool.shape
    max_pages = tables.shape[1]
    q = _check_kernel_inputs("paged_decode_attention", q, k_pool, v_pool,
                             k_scales, v_scales)
    if tables.device != q.device:
        raise ValueError(f"tables on {tables.device}, q on {q.device}")
    mode = _mode(k_scales, int4)
    tables = tables.to(torch.int32).contiguous()
    lens = _lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    splits = split_plan(b, hkv, t * (hq // hkv), max_pages * page,
                        kernels.sm_count(q.device))
    workspace = _workspace(q.device, b, hkv, d, splits)
    entry = getattr(kernels.load(), f"paged_decode_attention_{mode}")
    err = entry(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *_scale_ptrs(k_scales, v_scales), lens.data_ptr(),
        tables.data_ptr(), out.data_ptr(), b, t, hq, hkv, d, page,
        max_pages, n_pages, d ** -0.5, splits, *_ptrs(*workspace),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(_count_name("paged_decode_attention", mode), err)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cache_len,
                           tables: torch.Tensor, k_scales=None,
                           v_scales=None, int4: bool = False) -> torch.Tensor:
    """[B, T, Hq, D] attention output over a page pool; see the module
    docstring."""
    args = (q, k_pool, v_pool, cache_len, tables, k_scales, v_scales, int4)
    if q.device.type == "cuda":
        return paged_decode_attention_cuda(*args)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(*args)
    raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                     f"{q.device}")
