"""GQA attention over the KV cache for the decode path: a contiguous
cache (`decode_attention`, K1) or a page pool (`paged_decode_attention`,
K3).

Each dispatches on the tensors' device: CUDA launches the hand-written
kernel (kernels/decode_attention.cu), CPU runs the `*_plain` version, the
same function in plain PyTorch. There is no other route: a shape or
dtype the kernel cannot take raises.

The function is the bf16-cache mode of the JAX package's pallas kernel:
q [B, T, Hq, D] holds T new queries at absolute positions
[cache_len, cache_len + T); the caches [B, max_len, Hkv, D] already hold
the new tokens. Query t sees key positions p < cache_len + T with
p <= cache_len + t. Scores, softmax and p.v are f32; the output is
q.dtype. cache_len is an int, a 0-d tensor or a [B] tensor.

The paged form reads the same logical cache through a block table:
pools [n_pages, page, Hkv, D], tables [B, max_pages] int32, so logical
position p of row b is pool row tables[b, p // page] (clamped to
[0, n_pages - 1]), offset p % page, and max_len = max_pages * page.
Table entries past a row's live pages may be garbage.

The TPU kernel's VMEM gate that sent long prefills elsewhere does not
carry over: the CUDA kernel serves every prefill length.
"""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch import kernels

KERNEL_HEAD_DIMS = (32, 64, 128)


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


def _check_shapes(q, k_cache, v_cache):
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q [B,T,Hq,D] and k/v [B,max_len,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    b, t, hq, d = q.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or hq % k_cache.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path, and the
    reference the kernel is held against on the card)."""
    _check_shapes(q, k_cache, v_cache)
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
    # is NaN and a reused cache makes no promise about them.
    k = k_cache.float().masked_fill(dead[:, :, None, None], 0.0)
    v = v_cache.float().masked_fill(dead[:, :, None, None], 0.0)
    qg = q.float().reshape(b, t, hkv, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k) * d ** -0.5
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(b, t, hq, d).to(q.dtype)


def _check_kernel_inputs(name: str, q, k_cache, v_cache) -> torch.Tensor:
    """Raise on what the kernel cannot take; returns q contiguous."""
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for arg, x in (("q", q), ("k", k_cache), ("v", v_cache)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16 {arg}, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{arg} on {x.device}, q on {q.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous caches")
    q = q.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError(f"{name} kernel takes 16-byte aligned tensors")
    return q


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Launch kernels/decode_attention.cu on CUDA tensors."""
    _check_shapes(q, k_cache, v_cache)
    b, t, hq, d = q.shape
    max_len, hkv = k_cache.shape[1], k_cache.shape[2]
    q = _check_kernel_inputs("decode_attention", q, k_cache, v_cache)
    lens = _lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    lib = kernels.load()
    err = lib.decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, t, hq, hkv, d, max_len,
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check("decode_attention", err)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """[B, T, Hq, D] attention output; see the module docstring."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, cache_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")


def _check_paged_shapes(q, k_pool, v_pool, tables):
    if (q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape
            or tables.ndim != 2):
        raise ValueError(
            f"want q [B,T,Hq,D], pools [n_pages,page,Hkv,D] and tables "
            f"[B,max_pages], got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}, {tuple(tables.shape)}")
    b, t, hq, d = q.shape
    if (tables.shape[0] != b or k_pool.shape[3] != d
            or hq % k_pool.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} and tables "
                         f"{tuple(tables.shape)}")


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, cache_len,
                                 tables: torch.Tensor) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: gather each row's
    pages through its table into a contiguous cache, then
    `decode_attention_plain` (the JAX package's off-TPU path)."""
    _check_paged_shapes(q, k_pool, v_pool, tables)
    b, max_pages = tables.shape
    n_pages, page, hkv, d = k_pool.shape
    rows = tables.long().clamp(0, n_pages - 1)
    k = k_pool[rows].reshape(b, max_pages * page, hkv, d)
    v = v_pool[rows].reshape(b, max_pages * page, hkv, d)
    return decode_attention_plain(q, k, v, cache_len)


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, cache_len,
                                tables: torch.Tensor) -> torch.Tensor:
    """Launch the paged entry of kernels/decode_attention.cu on CUDA
    tensors."""
    _check_paged_shapes(q, k_pool, v_pool, tables)
    b, t, hq, d = q.shape
    n_pages, page, hkv, _ = k_pool.shape
    max_pages = tables.shape[1]
    q = _check_kernel_inputs("paged_decode_attention", q, k_pool, v_pool)
    if tables.device != q.device:
        raise ValueError(f"tables on {tables.device}, q on {q.device}")
    tables = tables.to(torch.int32).contiguous()
    lens = _lengths(cache_len, b, q.device)
    out = torch.empty_like(q)
    lib = kernels.load()
    err = lib.paged_decode_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), lens.data_ptr(),
        tables.data_ptr(), out.data_ptr(), b, t, hq, hkv, d, page, max_pages,
        n_pages, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check("paged_decode_attention", err)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cache_len,
                           tables: torch.Tensor) -> torch.Tensor:
    """[B, T, Hq, D] attention output over a page pool; see the module
    docstring."""
    if q.device.type == "cuda":
        return paged_decode_attention_cuda(q, k_pool, v_pool, cache_len,
                                           tables)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, cache_len,
                                            tables)
    raise ValueError(f"paged_decode_attention runs on cuda or cpu, not "
                     f"{q.device}")
