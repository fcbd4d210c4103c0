"""Incremental decoding with a KV cache: the serving path's model code.

Two cache layouts. `KVCache` is a preallocated [L, B, max_len, Hkv, D]
pair of tensors. `PagedKVCache` scatters each slot's logical cache over
a shared page pool [L, n_pages, page, Hkv, D] through a block table
[slots, max_pages]; pool row 0 is a trash page that is never allocated.
Both are written in place (the JAX package donates and rebuilds them;
here the update is a slice or index assignment), and the step functions
below update tables and lengths in place too, returning the cache they
were given.

cfg.kv_cache_dtype picks the storage: 'bf16' keeps K/V in cfg.dtype;
'int8' stores int8 with one f32 scale per (token, KV head) in scale
planes [L, B, Hkv, max_len] (paged: [L, n_pages, Hkv, page], indexed by
the same tables); 'int4' stores int8 at head_dim / 2, two nibbles a
byte, with the same scales. The step functions read the mode off the
cache they are given, as the JAX package does.

`decode_step` runs T new tokens through embed, per layer RMSNorm, q/k/v
projections, RoPE at absolute positions, the cache write, cached
attention, wo plus residual, RMSNorm, SwiGLU plus residual, then the
final norm and f32 logits. Attention goes through ops/decode_attention
(the CUDA kernels on the card), and int8 QuantWeight projections
through ops/quant.int8_matmul.

Nothing here synchronises with the device, so `generate` returns as soon
as its work is queued; the serving engines fetch the tokens later.
`PageAllocator` and `PrefixIndex` are the host-side bookkeeping of the
page pool, between device steps.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.models import moe, spec
from container_engine_accelerators_tpu_torch.models.llama import (
    MOE_DECODE_EP_TODO,
    Llama,
    LlamaConfig,
    check_kv_cache_dtype,
)
from container_engine_accelerators_tpu_torch.ops import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from container_engine_accelerators_tpu_torch.ops.quant import (
    QuantWeight,
    int8_matmul,
    int8_matmul_plain,
    quantize_kv,
    quantize_kv_int4,
)


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor        # [L, B, max_len, Hkv, D] (int4: D / 2)
    v: torch.Tensor        # [L, B, max_len, Hkv, D]
    # Tokens already cached: an int shared by every row (the batched
    # path; host-known, so writes are plain slices), or a [B] int32
    # tensor on the device (per-slot lengths).
    length: int | torch.Tensor
    # int8/int4 caches: f32 dequantization scales per (token, KV head),
    # head-major (ops/quant.quantize_kv); None for a bf16 cache.
    k_scales: torch.Tensor | None = None   # [L, B, Hkv, max_len]
    v_scales: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class PagedKVCache:
    """Slot caches scattered over a shared page pool. Pool row 0 is a
    permanent trash page: never allocated, it absorbs the writes of
    inactive slots (whose table rows may already belong to another
    request) and backs table entries past a slot's pages. Memory scales
    with the pool, not with slots x max_len: the serving engine keeps the
    live pages of all slots within n_pages - 1."""
    k_pool: torch.Tensor   # [L, n_pages, page, Hkv, D] (int4: D / 2)
    v_pool: torch.Tensor   # [L, n_pages, page, Hkv, D]
    tables: torch.Tensor   # [slots, max_pages] int32 pool row per page
    length: torch.Tensor   # [slots] int32 live length per slot
    # int8/int4 pools: scale pools indexed by the same tables.
    k_scales: torch.Tensor | None = None   # [L, n_pages, Hkv, page] f32
    v_scales: torch.Tensor | None = None

    @property
    def page(self) -> int:
        return self.k_pool.shape[2]


def _kv_dtype(cfg: LlamaConfig) -> torch.dtype:
    """The cache storage dtype cfg asks for: int8 for 'int8' and 'int4'
    (two nibbles a byte), else cfg.dtype."""
    check_kv_cache_dtype(cfg)
    return torch.int8 if cfg.kv_cache_dtype != "bf16" else cfg.dtype


def _storage_token(arr: torch.Tensor, cfg: LlamaConfig):
    """How a cache K/V tensor stores its payload: 'int4' for int8 at
    head_dim / 2 (the shape is the mode), else its dtype. Passed as
    init_cache's `dtype`, it makes a temporary prefill cache of the
    layout of the cache it is copied into."""
    if arr.dtype == torch.int8 and arr.shape[-1] == cfg.head_dim // 2:
        return "int4"
    return arr.dtype


def _storage_layout(cfg: LlamaConfig, dtype) -> tuple[torch.dtype, int]:
    """(storage dtype, payload width) of a cache allocation: `dtype` None
    follows cfg.kv_cache_dtype; 'int4' (a _storage_token) is the nibble
    layout; any other dtype is taken as it is, at head_dim."""
    if dtype is None:
        dtype = _kv_dtype(cfg)
        return dtype, (cfg.head_dim // 2 if cfg.kv_cache_dtype == "int4"
                       else cfg.head_dim)
    if dtype == "int4":
        return torch.int8, cfg.head_dim // 2
    return dtype, cfg.head_dim


def _scale_planes(dtype: torch.dtype, shape: tuple, device) -> dict:
    """Zeroed f32 k_scales/v_scales of `shape` for an int8 payload."""
    if dtype != torch.int8:
        return {}
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("k_scales", "v_scales")}


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: str | torch.device, dtype=None) -> KVCache:
    """Zeroed cache in the layout cfg.kv_cache_dtype asks for, or `dtype`
    (a torch dtype, or 'int4'); an int8 layout gets zeroed scale planes
    [L, batch, Hkv, max_len] f32."""
    dtype, d_store = _storage_layout(cfg, dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, d_store)
    scales = (cfg.n_layers, batch, cfg.n_kv_heads, max_len)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0, **_scale_planes(dtype, scales, device))


def init_slot_cache(cfg: LlamaConfig, slots: int, max_len: int,
                    device: str | torch.device, dtype=None) -> KVCache:
    """KVCache with per-slot lengths ([slots] int32, all zero)."""
    cache = init_cache(cfg, slots, max_len, device, dtype=dtype)
    return dataclasses.replace(
        cache, length=torch.zeros(slots, dtype=torch.int32, device=device))


def init_paged_cache(cfg: LlamaConfig, slots: int, n_pages: int, page: int,
                     max_pages: int, device: str | torch.device,
                     dtype=None) -> PagedKVCache:
    """n_pages zeroed pool pages (row 0 is the trash page) shared by
    `slots` slots of logical capacity max_pages * page tokens each; an
    int8 layout gets zeroed scale pools [L, n_pages, Hkv, page] f32."""
    dtype, d_store = _storage_layout(cfg, dtype)
    shape = (cfg.n_layers, n_pages, page, cfg.n_kv_heads, d_store)
    scales = (cfg.n_layers, n_pages, cfg.n_kv_heads, page)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=dtype, device=device),
        v_pool=torch.zeros(shape, dtype=dtype, device=device),
        tables=torch.zeros(slots, max_pages, dtype=torch.int32,
                           device=device),
        length=torch.zeros(slots, dtype=torch.int32, device=device),
        **_scale_planes(dtype, scales, device))


def _proj(h: torch.Tensor, w, plain: bool) -> torch.Tensor:
    if isinstance(w, QuantWeight):
        matmul = int8_matmul_plain if plain else int8_matmul
        out = matmul(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], -1)
    return h @ w


_MOE_DECODE_SKEW_WARNED = False
# A call of at most this many tokens computes every expert for every
# token (no host sync, every expert's weights read once); a longer one
# computes only the routed pairs (top_k / E of the FLOPs, one host sync
# and a matmul a weight an expert). chip_smoke.py's moe phase times both
# on one layer at Mixtral-8x7B's widths: on an H100 every expert is the
# faster up to 256 tokens (0.95-1.19 ms against 1.39-1.60 at 8-256), the
# routed pairs at 512 (1.58 ms against 2.12).
MOE_ALL_EXPERTS_TOKENS = 256


def _moe_ffn_decode(h2: torch.Tensor, layer, cfg: LlamaConfig
                    ) -> torch.Tensor:
    """The mixture-of-experts FFN at decode: h2 [B, T, D] normalized ->
    [B, T, D] (the caller adds the residual).

    Routing is per token, moe._gating's top-k with nothing dropped (the
    dropless token-choice semantics), so a token's output does not
    depend on what else the engine batched with it: capacity routing
    cannot be reproduced incrementally. The JAX package computes every
    expert for every token and weights the unchosen ones by exactly 0;
    this computes the same function, over all experts up to
    MOE_ALL_EXPERTS_TOKENS tokens and over the routed pairs alone above
    (moe.dropless_ffn), and combines each token's k outputs in rank
    order."""
    global _MOE_DECODE_SKEW_WARNED
    if cfg.moe_decode_ep:
        raise NotImplementedError(MOE_DECODE_EP_TODO)
    if (not cfg.moe_dropless and cfg.moe_router == "token_choice"
            and not _MOE_DECODE_SKEW_WARNED):
        # Once a process: a capacity-dropping training config decodes
        # dropless, so any token training dropped is train/serve skew.
        _MOE_DECODE_SKEW_WARNED = True
        warnings.warn(
            "decoding an n_experts config with moe_dropless=False: the "
            "decode path always routes dropless per-token top-k, so "
            "outputs match training only where training dropped no "
            "tokens (capacity-factor cumsums cannot be reproduced "
            "incrementally). Train with moe_dropless=True to make the "
            "semantics identical.", stacklevel=2)
    if isinstance(layer.w_gate, QuantWeight):
        raise NotImplementedError(
            "int8-quantized expert weights are not supported on the MoE "
            "decode path")
    b, t, d = h2.shape
    x = h2.reshape(b * t, d)
    _, gate_vals, expert_idx = moe._gating(moe._router_logits(x, layer),
                                           cfg.moe_top_k)
    if b * t > MOE_ALL_EXPERTS_TOKENS:
        out = moe.dropless_ffn(x, layer, cfg.n_experts, gate_vals,
                               expert_idx)
    else:
        out = moe_ffn_every_expert(x, layer, gate_vals, expert_idx)
    return out.view(b, t, d)


def moe_ffn_every_expert(x: torch.Tensor, layer, gate_vals: torch.Tensor,
                         expert_idx: torch.Tensor) -> torch.Tensor:
    """moe.dropless_ffn's function, computed as the JAX package does:
    every expert's SwiGLU FFN over every token of x [N, D] (batched
    matmuls over the [E] stacks, no host sync), then each token's k
    chosen outputs combined by moe.sum_top_k."""
    w_gate, w_up, w_down = (w.to(x.dtype) for w in (
        layer.w_gate, layer.w_up, layer.w_down))
    gate = F.silu(torch.matmul(x, w_gate))               # [E, N, F]
    down = torch.matmul(gate * torch.matmul(x, w_up), w_down)
    picked = down[expert_idx, torch.arange(x.shape[0], device=x.device)[
        :, None]]                                        # [N, k, D]
    return moe.sum_top_k(picked, gate_vals)


def decode_step(model: Llama, cache: KVCache | PagedKVCache,
                tokens: torch.Tensor, cfg: LlamaConfig,
                active: torch.Tensor | None = None,
                plain: bool = False, advance: bool = True
                ) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """Run T new tokens ([B, T]; T = prompt length for prefill, 1 for
    decode). Returns (logits [B, T, vocab] f32, cache with the new K/V
    written in place and the lengths advanced).

    `advance=False` is the speculative verify mode: K/V for all T
    positions are written and attended as usual, but the lengths do not
    move. The caller commits the accepted prefix with advance_lengths;
    the rejected positions sit past the live length, masked by position,
    and the next write overwrites them.

    With per-slot lengths (and always on a paged cache), row b writes at
    min(length[b], max_len - T) and `active` ([B] bool) gates which rows'
    lengths advance; inactive rows still compute. On a slot cache they
    write where the next prefill overwrites; on a paged cache their
    writes, scales included, go to the trash row 0, since their table
    rows may already belong to another request. The pages a write lands
    in must already be in the table.

    The KV mode is the cache's, not cfg's: an int8 cache holds int8 K/V
    (int4 at head_dim / 2), and the new tokens are quantized after RoPE
    and written with their scales through the same indices. `plain=True`
    runs the kernels' plain PyTorch versions on any device (the on-card
    reference for the kernel path)."""
    b, t = tokens.shape
    dev = tokens.device
    paged = isinstance(cache, PagedKVCache)
    if paged:
        max_pages = cache.tables.shape[1]
        max_len = max_pages * cache.page     # logical capacity
        k_all, v_all = cache.k_pool, cache.v_pool
    else:
        max_len = cache.k.shape[2]
        k_all, v_all = cache.k, cache.v
    quantized = k_all.dtype == torch.int8
    int4 = _storage_token(k_all, cfg) == "int4"
    quantize = quantize_kv_int4 if int4 else quantize_kv
    per_slot = isinstance(cache.length, torch.Tensor)
    hd, dt = cfg.head_dim, cfg.dtype
    cos, sin = rope_frequencies(hd, max_len, cfg.rope_theta, device=dev)
    steps = torch.arange(t, device=dev)
    if per_slot:
        row_len = cache.length.clamp(max=max_len - t)           # [B]
        positions = row_len[:, None].long() + steps             # [B, T]
        att_len = row_len.to(torch.int32)
        rows = torch.arange(b, device=dev)[:, None]
    else:
        if cache.length + t > max_len:
            raise ValueError(f"{t} tokens past length {cache.length} "
                             f"overflow the cache (max_len {max_len})")
        positions = (cache.length + steps)[None, :].expand(b, t)
        att_len = torch.full((b,), cache.length, dtype=torch.int32,
                             device=dev)
    if paged:
        # Token i of slot s lands at pool row tables[s, pos // page],
        # offset pos % page. No accumulate: several inactive slots may
        # hit the same trash cell, and which write wins does not matter.
        page = cache.page
        w_rows = cache.tables[rows, (positions // page).clamp(
            max=max_pages - 1)].long()
        if active is not None:
            w_rows = torch.where(active[:, None], w_rows, 0)
        w_offs = positions % page
        paged_attn = (paged_decode_attention_plain if plain
                      else paged_decode_attention)

        def attention(q, k_pool, v_pool, lens, ks, vs):
            return paged_attn(q, k_pool, v_pool, lens, cache.tables, ks, vs,
                              int4)

        def write(pool, new, spool=None, new_scales=None):
            pool[w_rows, w_offs] = new
            if spool is not None:   # scales [B, Hkv, T] at [row, :, off]
                spool[w_rows, :, w_offs] = new_scales.transpose(1, 2)
    else:
        attn_fn = decode_attention_plain if plain else decode_attention

        def attention(q, k_cache, v_cache, lens, ks, vs):
            return attn_fn(q, k_cache, v_cache, lens, ks, vs, int4)

        def write(c, new, sc=None, new_scales=None):
            if per_slot:
                c[rows, positions] = new
                if sc is not None:
                    sc[rows, :, positions] = new_scales.transpose(1, 2)
            else:
                c[:, cache.length:cache.length + t] = new
                if sc is not None:
                    sc[:, :, cache.length:cache.length + t] = new_scales

    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q = _proj(h, layer.wq, plain).reshape(b, t, -1, hd)
        k = _proj(h, layer.wk, plain).reshape(b, t, -1, hd)
        v = _proj(h, layer.wv, plain).reshape(b, t, -1, hd)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        k_cache, v_cache = k_all[li], v_all[li]
        ks = vs = None
        if quantized:
            ks, vs = cache.k_scales[li], cache.v_scales[li]
            # One call for K and V (scales are per token and head, so
            # stacking changes no value): half the eager ops on the host.
            kv_q, kv_s = quantize(torch.stack([k, v]))
            write(k_cache, kv_q[0], ks, kv_s[0])
            write(v_cache, kv_q[1], vs, kv_s[1])
        else:
            write(k_cache, k.to(k_cache.dtype))
            write(v_cache, v.to(v_cache.dtype))
        attn = attention(q.to(dt), k_cache, v_cache, att_len, ks, vs)
        x = x + _proj(attn.reshape(b, t, -1), layer.wo, plain)
        h2 = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
        if cfg.n_experts:
            x = x + _moe_ffn_decode(h2, layer, cfg)
            continue
        gate = F.silu(_proj(h2, layer.w_gate, plain))
        up = _proj(h2, layer.w_up, plain)
        x = x + _proj(gate * up, layer.w_down, plain)

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    # The vocab projection is a true f32 product (TF32 stays off).
    logits = _proj(x.float(), model.lm_head, plain)

    if not advance:
        return logits, cache
    if per_slot:
        new_len = (cache.length + t).clamp(max=max_len)
        if active is not None:
            new_len = torch.where(active, new_len, cache.length)
        new_len = new_len.to(torch.int32)
    else:
        new_len = cache.length + t
    return logits, dataclasses.replace(cache, length=new_len)


def decode_step_slots(model: Llama, cache: KVCache, tokens: torch.Tensor,
                      active: torch.Tensor, cfg: LlamaConfig,
                      plain: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One decode step for every slot: tokens [B], active [B] bool.
    Returns (last-token logits [B, vocab] f32, cache)."""
    logits, cache = decode_step(model, cache, tokens[:, None], cfg,
                                active=active, plain=plain)
    return logits[:, 0], cache


def _sample(logits: torch.Tensor, generator: torch.Generator | None
            ) -> torch.Tensor:
    """One categorical draw per row of `logits` [B, V]: argmax of p / E
    with E ~ Exp(1), which is what torch.multinomial does for one draw,
    without its input check, whose .item() would wait for the device."""
    probs = torch.softmax(logits.float(), dim=-1)
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / noise).argmax(dim=-1)


def _slot_view(planes: torch.Tensor | None, slot: int):
    """Slot `slot` of [L, slots, ...] cache planes, as an [L, 1, ...] view
    (None stays None)."""
    return None if planes is None else planes[:, slot:slot + 1]


def prefill_slot(model: Llama, cache: KVCache, slot: int,
                 tokens: torch.Tensor, true_len: int, cfg: LlamaConfig,
                 plain: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Prefill one request into slot `slot` of a slot cache: `tokens`
    [Tp] (the prompt padded to a bucket; the padding's K/V sits past
    true_len) runs through a temporary cache of the slot cache's layout,
    which is then copied, scales included, into the slot's first Tp
    positions. Sets length[slot] = true_len in place. Returns (logits of
    the last live token [vocab] f32, cache)."""
    tp = tokens.shape[0]
    tmp = init_cache(cfg, 1, tp, cache.k.device,
                     dtype=_storage_token(cache.k, cfg))
    logits, tmp = decode_step(model, tmp, tokens[None, :], cfg, plain=plain)
    cache.k[:, slot, :tp] = tmp.k[:, 0]
    cache.v[:, slot, :tp] = tmp.v[:, 0]
    if cache.k_scales is not None:   # [L, slots, Hkv, max_len]
        cache.k_scales[:, slot, :, :tp] = tmp.k_scales[:, 0]
        cache.v_scales[:, slot, :, :tp] = tmp.v_scales[:, 0]
    cache.length[slot] = true_len
    return logits[0, true_len - 1], cache


def prefill_suffix_slot(model: Llama, cache: KVCache, slot: int,
                        suffix_tokens: torch.Tensor, start: int,
                        new_len: int, cfg: LlamaConfig, plain: bool = False
                        ) -> tuple[torch.Tensor, KVCache]:
    """(Continue) prefilling slot `slot` of a slot cache: the chunk
    `suffix_tokens` [Ts] (padded; the padding's K/V sits past new_len,
    where later chunks and decode overwrite it) lands at positions
    [start, start + Ts). `new_len` is the slot's live length after the
    chunk. Writes the slot's cache and sets length[slot] in place.
    Returns (logits of the last live token [vocab] f32, meaningful on
    the final chunk, and the cache)."""
    sub = KVCache(**{name: _slot_view(getattr(cache, name), slot)
                     for name in ("k", "v", "k_scales", "v_scales")},
                  length=torch.full((1,), start, dtype=torch.int32,
                                    device=cache.length.device))
    logits, _ = decode_step(model, sub, suffix_tokens[None, :], cfg,
                            plain=plain)
    cache.length[slot] = new_len
    return logits[0, max(new_len - start - 1, 0)], cache


def decode_step_paged(model: Llama, cache: PagedKVCache,
                      tokens: torch.Tensor, active: torch.Tensor,
                      cfg: LlamaConfig, plain: bool = False
                      ) -> tuple[torch.Tensor, PagedKVCache]:
    """One decode step for every slot of a paged cache: tokens [slots],
    active [slots] bool. Each active slot's next page (tables[s,
    len // page]) must already be assigned. Returns (logits [slots,
    vocab] f32, cache)."""
    logits, cache = decode_step(model, cache, tokens[:, None], cfg,
                                active=active, plain=plain)
    return logits[:, 0], cache


def prefill_slot_paged(model: Llama, cache: PagedKVCache, slot: int,
                       rows: torch.Tensor, tokens: torch.Tensor,
                       true_len: int, cfg: LlamaConfig, plain: bool = False
                       ) -> tuple[torch.Tensor, PagedKVCache]:
    """Prefill one request into the paged cache: `tokens` [Tp] (the
    prompt padded to a page multiple) runs through a temporary contiguous
    cache of the pools' layout, whose pages, and scale pages, are then
    scattered to pool rows `rows` [Tp // page]; the slot's first table
    entries point at them and length[slot] = true_len, in place. Returns
    (logits of the last live token [vocab] f32, cache)."""
    tp = tokens.shape[0]
    n_layers, _, page, hkv, d_store = cache.k_pool.shape
    if tp % page or rows.shape != (tp // page,):
        raise ValueError(f"{tp} tokens need {tp} // {page} page rows and a "
                         f"page multiple, got rows {tuple(rows.shape)}")
    n_pg = tp // page
    tmp = init_cache(cfg, 1, tp, cache.k_pool.device,
                     dtype=_storage_token(cache.k_pool, cfg))
    logits, tmp = decode_step(model, tmp, tokens[None, :], cfg, plain=plain)
    rows = rows.long()
    cache.k_pool[:, rows] = tmp.k.reshape(n_layers, n_pg, page, hkv, d_store)
    cache.v_pool[:, rows] = tmp.v.reshape(n_layers, n_pg, page, hkv, d_store)
    if cache.k_scales is not None:
        # [L, 1, Hkv, Tp] -> per page [L, n_pg, Hkv, page]
        for pool, planes in ((cache.k_scales, tmp.k_scales),
                             (cache.v_scales, tmp.v_scales)):
            pool[:, rows] = planes.reshape(n_layers, hkv, n_pg,
                                           page).transpose(1, 2)
    cache.tables[slot, :n_pg] = rows.to(torch.int32)
    cache.length[slot] = true_len
    return logits[0, true_len - 1], cache


def set_slot_pages(cache: PagedKVCache, slot: int, rows: torch.Tensor,
                   length: int) -> PagedKVCache:
    """Replace slot's table row with `rows` ([max_pages] int32 on the
    cache's device: shared prefix rows, fresh rows, then trash-0
    padding) and set its length, in place."""
    cache.tables[slot] = rows
    cache.length[slot] = length
    return cache


def prefill_suffix_paged(model: Llama, cache: PagedKVCache, slot: int,
                         suffix_tokens: torch.Tensor, true_len: int,
                         cfg: LlamaConfig, plain: bool = False
                         ) -> tuple[torch.Tensor, PagedKVCache]:
    """Prefill the next chunk of a slot whose first length[slot] tokens
    are already in the cache (shared prefix pages, or earlier chunks):
    the chunk [Ts] (padded to a page multiple) lands at
    [length[slot], length[slot] + Ts), and the table must already cover
    those pages. Writes the pools and sets length[slot] = true_len in
    place. Returns (logits of the last live token [vocab] f32, cache).
    The start is read on the device, so nothing waits for it."""
    start = cache.length[slot:slot + 1].clone()
    sub = dataclasses.replace(cache, tables=cache.tables[slot:slot + 1],
                              length=start)
    logits, _ = decode_step(model, sub, suffix_tokens[None, :], cfg,
                            plain=plain)
    cache.length[slot] = true_len
    last = (true_len - 1 - start).clamp(min=0).long()
    return logits[0].index_select(0, last)[0], cache


def assign_pages(cache: PagedKVCache, page_pos: torch.Tensor,
                 rows: torch.Tensor, mask: torch.Tensor) -> PagedKVCache:
    """Point slot s's table entry page_pos[s] at pool row rows[s] where
    mask[s]; other slots keep theirs. One masked scatter, in place, for
    every slot that crosses a page boundary this step."""
    idx = torch.arange(cache.tables.shape[0], device=cache.tables.device)
    pos = page_pos.long()
    cur = cache.tables[idx, pos]
    cache.tables[idx, pos] = torch.where(mask, rows.to(torch.int32), cur)
    return cache


def merge_tokens(last: torch.Tensor, overrides: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Inject host-known tokens into the device-resident last-token
    vector: `overrides` where `mask`, else `last`. All [B]; int32 out.
    The serving engine keeps each slot's last token on the device between
    ticks; a freshly prefilled slot's first token, sampled on the host,
    enters the vector this way without waiting for the device."""
    return torch.where(mask, overrides.to(last.dtype), last).to(torch.int32)


def pick_tokens(logits: torch.Tensor, temps: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
    """Per-slot sampling: greedy where temp <= 0, categorical at the
    slot's own temperature otherwise. logits [B, V], temps [B]."""
    greedy = logits.argmax(dim=-1)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    sampled = _sample(logits / safe_t[:, None], generator)
    return torch.where(temps > 0, sampled, greedy)


def generate(model: Llama, prompt: torch.Tensor, cfg: LlamaConfig,
             max_new_tokens: int, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             plain: bool = False, speculate: str = "off", spec_k: int = 4,
             draft_layers: int = 2,
             spec_stats: dict | None = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation. prompt: [B, T0]
    integer tokens. Returns [B, T0 + max_new_tokens] int64 on the
    prompt's device, without waiting for the device (speculation reads
    the device every round).

    The cache holds T0 + max_new_tokens positions. Unlike the JAX
    package, that length is not rounded up to a multiple of 128: the
    padding existed for the TPU kernel's tiling; the CUDA kernel takes
    any length, and padding would only add masked slots that change no
    token. Sampling draws from `generator` (a fixed seed when None), so
    a seed gives the same tokens on the same device; the draws are not
    jax.random's.

    `speculate` ('ngram' or 'draft') turns on speculative decoding:
    greedy verification gives the tokens of speculate='off' at
    temperature 0, and only the number of model passes changes. 'ngram'
    drafts by prompt lookup (models/spec.ngram_draft, no weights);
    'draft' runs the first `draft_layers` layers of the model as the
    proposer. It needs temperature 0. `spec_stats` (a dict) accumulates
    drafted / accepted / verifies / committed totals."""
    if speculate not in ("off", "ngram", "draft"):
        raise ValueError(f"speculate must be 'off', 'ngram' or 'draft', "
                         f"got {speculate!r}")
    if speculate != "off":
        if temperature > 0.0:
            raise ValueError(
                "speculative decoding verifies greedily; it requires "
                "temperature=0")
        return _generate_speculative(model, prompt, cfg, max_new_tokens,
                                     mode=speculate, spec_k=spec_k,
                                     draft_layers=draft_layers,
                                     spec_stats=spec_stats, plain=plain)
    b, t0 = prompt.shape
    prompt = prompt.long()
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    cache = init_cache(cfg, b, t0 + max_new_tokens, prompt.device)

    def pick(logits):
        last = logits[:, -1]
        if temperature <= 0.0:
            return last.argmax(dim=-1)
        return _sample(last / temperature, generator)

    logits, cache = decode_step(model, cache, prompt, cfg, plain=plain)
    tok = pick(logits)
    out = [prompt, tok[:, None]]
    for _ in range(1, max_new_tokens):
        logits, cache = decode_step(model, cache, tok[:, None], cfg,
                                    plain=plain)
        tok = pick(logits)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def draft_layer_count(cfg: LlamaConfig, draft_layers: int) -> int:
    """The self-draft's depth: `draft_layers`, at least 1 and below the
    model's own depth."""
    return max(1, min(draft_layers, cfg.n_layers - 1))


def _generate_speculative(model: Llama, prompt: torch.Tensor,
                          cfg: LlamaConfig, max_new_tokens: int,
                          mode: str = "ngram", spec_k: int = 4,
                          draft_layers: int = 2,
                          spec_stats: dict | None = None,
                          plain: bool = False) -> torch.Tensor:
    """Speculative generate: generate(temperature=0)'s contract with
    fewer model passes. The cache has per-row lengths even at batch > 1,
    since rows accept different counts and part after the first verify.
    The prompt is prefilled through verify_step and committed, then each
    round drafts, verifies k+1 positions in one pass and commits the
    accepted prefix; the host reads each round's argmax."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    b, t0 = prompt.shape
    dev = prompt.device
    prompt = prompt.long()
    # Verify writes K/V at [len, len + k + 1) before it commits, so the
    # cache needs k + 1 positions of slack past the last committed one:
    # without them the per-row write clamp would fold candidate writes
    # onto committed positions near the end.
    max_len = t0 + max_new_tokens + spec_k + 1
    cache = init_slot_cache(cfg, b, max_len, dev)
    all_on = torch.ones(b, dtype=torch.bool, device=dev)
    logits, cache = verify_step(model, cache, prompt, all_on, cfg,
                                plain=plain)
    cache = advance_lengths(
        cache, torch.full((b,), t0, dtype=torch.int32, device=dev), all_on)
    last = logits[:, -1].argmax(dim=-1).cpu().numpy().astype(np.int32)

    if mode == "draft":
        n_draft = draft_layer_count(cfg, draft_layers)
        draft_cfg = spec.draft_config(cfg, n_draft)
        draft_model = spec.truncate_params(model, n_draft)
        draft_cache = init_slot_cache(draft_cfg, b, max_len, dev)
        _, draft_cache = decode_step(draft_model, draft_cache, prompt,
                                     draft_cfg, plain=plain)

    out = np.zeros((b, t0 + max_new_tokens), np.int64)
    out[:, :t0] = prompt.cpu().numpy()
    out[:, t0] = last
    produced = np.ones((b,), np.int32)
    # Draft mode commits at most k (never the bonus): on full acceptance
    # the bonus token's K/V is missing from the draft cache (the drafter
    # stepped k times), so committing it would part the two caches. The
    # bonus still becomes the next round's last token.
    cap = spec_k if mode == "draft" else spec_k + 1

    while (produced < max_new_tokens).any():
        act = produced < max_new_tokens
        if mode == "ngram":
            drafts = np.zeros((b, spec_k), np.int32)
            for i in range(b):
                if act[i]:
                    d = spec.ngram_draft(out[i, :t0 + produced[i]], spec_k)
                    drafts[i, :len(d)] = d
        else:
            tok = torch.from_numpy(last).long().to(dev)[:, None]
            cols = []
            for _ in range(spec_k):
                dl, draft_cache = decode_step(draft_model, draft_cache, tok,
                                              draft_cfg, plain=plain)
                tok = dl[:, -1].argmax(dim=-1)[:, None]
                cols.append(tok)
            drafts = torch.cat(cols, dim=1).cpu().numpy().astype(np.int32)

        tokens = np.concatenate([last[:, None], drafts], axis=1)
        act_dev = torch.from_numpy(act).to(dev)
        logits, cache = verify_step(model, cache,
                                    torch.from_numpy(tokens).long().to(dev),
                                    act_dev, cfg, plain=plain)
        greedy = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        counts, bonus = spec.greedy_verify(greedy, tokens)

        commit = np.zeros((b,), np.int32)
        for i in range(b):
            if not act[i]:
                continue
            a = int(counts[i]) - 1          # accepted draft tokens
            seq = list(tokens[i, 1:1 + a]) + [int(bonus[i])]
            c = min(len(seq), cap, int(max_new_tokens - produced[i]))
            out[i, t0 + produced[i]:t0 + produced[i] + c] = seq[:c]
            last[i] = seq[c - 1]
            produced[i] += c
            commit[i] = c
        cache = advance_lengths(cache, torch.from_numpy(commit).to(dev),
                                act_dev)
        if spec_stats is not None:
            n_act = int(act.sum())
            spec_stats["drafted"] = (spec_stats.get("drafted", 0)
                                     + n_act * spec_k)
            spec_stats["accepted"] = (spec_stats.get("accepted", 0)
                                      + int(counts[act].sum()) - n_act)
            spec_stats["verifies"] = spec_stats.get("verifies", 0) + n_act
            spec_stats["committed"] = (spec_stats.get("committed", 0)
                                       + int(commit.sum()))
        if mode == "draft":
            # The drafter's cached prefix matches the main cache's
            # committed tokens position for position, so the length is
            # the whole re-anchor.
            draft_cache = dataclasses.replace(draft_cache,
                                              length=cache.length.clone())
    return torch.from_numpy(out).to(dev)


# ---------- speculative decoding: verify and commit ----------
#
# Draft-then-verify: the engine proposes k tokens (models/spec.py),
# verify_step scores all k+1 positions in one model pass, and
# advance_lengths commits the accepted prefix. The length is what makes
# a position live: verify writes K/V for every candidate, and rejected
# ones stay past the committed length, masked by position and
# overwritten by the next append, so a rollback costs nothing.


def verify_step(model: Llama, cache: KVCache | PagedKVCache,
                tokens: torch.Tensor, active: torch.Tensor | None,
                cfg: LlamaConfig, plain: bool = False
                ) -> tuple[torch.Tensor, KVCache | PagedKVCache]:
    """Score k+1 speculative candidates in one pass: tokens [B, k+1] =
    [last committed but uncached token, draft_1..draft_k] a row. Returns
    (logits [B, k+1, vocab] f32, cache with the candidates' K/V written
    and the lengths unchanged). On a paged cache the pages covering
    length + k + 1 must already be in the table. Commit with
    advance_lengths."""
    return decode_step(model, cache, tokens, cfg, active=active,
                       plain=plain, advance=False)


def advance_lengths(cache: KVCache | PagedKVCache, counts: torch.Tensor,
                    active: torch.Tensor | None = None
                    ) -> KVCache | PagedKVCache:
    """Commit `counts` verified tokens a row ([B] int32 on the cache's
    device): the lengths advance, clamped to the capacity, where
    `active` (all rows when None); nothing else moves."""
    if isinstance(cache, PagedKVCache):
        max_len = cache.tables.shape[1] * cache.page
    else:
        max_len = cache.k.shape[2]
    new_len = (cache.length + counts.to(torch.int32)).clamp(max=max_len)
    if active is not None:
        new_len = torch.where(active, new_len, cache.length)
    return dataclasses.replace(cache, length=new_len.to(torch.int32))


class PageAllocator:
    """Host-side refcounted free list over the pool's page rows. Row 0
    is the trash page and is never handed out. Decisions are made
    between device steps; the device only sees the resulting tables.

    Refcounts exist for prefix sharing: a full prompt page reused by a
    second request (or kept by the prefix index) is shared, not copied,
    and returns to the free list when its last holder frees it. Only
    full pages are shared and decode writes only at positions at or past
    a slot's length, so a shared page is never written.

    Thermal tracking: every alloc and share stamps the row's last-touch
    time and touch count, and `set_owner` its tenant, in host dicts
    updated inside bookkeeping that already runs between device steps (no
    device work). `thermal_census()` folds them into an O(pages)
    hot/warm/cold snapshot with a sampled reuse-distance profile, the
    same dict as the JAX package's. Time is `self.clock` (monotonic; a
    test may put a clock of its own there) unless a call takes `now`."""

    #: one reuse-distance sample per this many touches: the census stays
    #: O(pages) and a touch O(1) amortised (the stack-distance walk is
    #: O(distance), paid on sampled touches only).
    REUSE_SAMPLE_EVERY = 16

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (row 0 is reserved)")
        self._free = list(range(n_pages - 1, 0, -1))  # pop() -> low rows
        self._refs: dict[int, int] = {}
        self.n_pages = n_pages
        # Thermal bookkeeping, keyed by allocated row and dropped when
        # the refcount reaches zero, so the census after a drain is
        # empty, as the leak check wants.
        self.clock = time.monotonic
        self._alloc_ts: dict[int, float] = {}
        self._last_touch: dict[int, float] = {}
        self._touch_count: dict[int, int] = {}
        # row -> (tenant, request class); the first owner keeps it, so a
        # shared prefix page stays with the tenant that paid for it.
        self._owner: dict[int, tuple[str, str]] = {}
        self._touch_seq = 0
        # LRU stack of touched rows (most recent last) for Mattson stack
        # distances; freed rows leave it, so it is at most the pool.
        self._stack: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        self._reuse_samples: collections.deque[int] = \
            collections.deque(maxlen=1024)

    def _touch(self, row: int, now: float) -> None:
        self._touch_seq += 1
        self._last_touch[row] = now
        self._touch_count[row] = self._touch_count.get(row, 0) + 1
        stack = self._stack
        if row in stack:
            if self._touch_seq % self.REUSE_SAMPLE_EVERY == 0:
                d = 0
                for r in reversed(stack):
                    if r == row:
                        break
                    d += 1
                self._reuse_samples.append(d)
            stack.move_to_end(row)
        else:
            stack[row] = None  # first touch: infinite distance, unsampled

    def touch(self, rows: list[int], now: float | None = None) -> None:
        """Refresh last-touch on allocated rows (a page read again
        outside alloc and share); unallocated rows are ignored."""
        t = self.clock() if now is None else now
        for r in rows:
            if r in self._refs:
                self._touch(r, t)

    def set_owner(self, rows: list[int], tenant: str | None,
                  req_class: str | None = None) -> None:
        """Attribute allocated rows to a tenant and request class. The
        first owner keeps a row: a prefix page shared by later tenants
        stays attributed to the one that computed it."""
        if tenant is None:
            return
        for r in rows:
            if r in self._refs and r not in self._owner:
                self._owner[r] = (str(tenant), str(req_class or "-"))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Allocated rows (any refcount), the trash row excluded."""
        return self.n_pages - 1 - len(self._free)

    def refcount(self, row: int) -> int:
        return self._refs.get(row, 0)

    def outstanding_rows(self) -> dict[int, int]:
        """row -> refcount of every allocated row; empty means every page
        is back on the free list."""
        return dict(self._refs)

    def alloc(self, n: int = 1) -> list[int] | None:
        """n pool rows (refcount 1 each), or None (nothing allocated)
        if there are not enough."""
        if n > len(self._free):
            return None
        rows = [self._free.pop() for _ in range(n)]
        now = self.clock()
        for r in rows:
            self._refs[r] = 1
            self._alloc_ts[r] = now
            self._touch(r, now)
        return rows

    def share(self, row: int) -> int:
        """Take another reference on an allocated row."""
        if self._refs.get(row, 0) < 1:
            raise ValueError(f"share of unallocated page row {row}")
        self._refs[row] += 1
        self._touch(row, self.clock())
        return row

    def free(self, rows: list[int]) -> None:
        """Drop one reference per row; rows reaching zero return to the
        free list. Checks every row before it frees any."""
        for r in rows:
            if not 0 < r < self.n_pages:
                raise ValueError(f"bad page row {r}")
            if self._refs.get(r, 0) < 1:
                raise ValueError(f"double free of page row {r}")
        for r in rows:
            self._refs[r] -= 1
            if self._refs[r] == 0:
                del self._refs[r]
                self._free.append(r)
                self._alloc_ts.pop(r, None)
                self._last_touch.pop(r, None)
                self._touch_count.pop(r, None)
                self._owner.pop(r, None)
                self._stack.pop(r, None)

    def thermal_census(self, *, hot_s: float = 2.0, warm_s: float = 10.0,
                       now: float | None = None,
                       active_rows=(), prefix_rows=(),
                       top_n: int = 8) -> dict:
        """O(pages) thermal snapshot of the pool. `active_rows`, the rows
        of live slots, are read by the card every tick, so they count hot
        whatever their last host touch (an active page never reports
        cold). `prefix_rows` are the prefix index's rows: a cold page
        among them is evictable, a cold page in neither set an orphan
        (a leak sign)."""
        t = self.clock() if now is None else now
        active = set(active_rows)
        prefix = set(prefix_rows)
        buckets = {"hot": 0, "warm": 0, "cold": 0}
        tenants: dict[str, dict[str, int]] = {}
        idles: list[float] = []
        ages: list[float] = []
        cold_evictable = cold_orphan = 0
        per_page: list[tuple[float, int]] = []
        for row in self._refs:
            pinned = row in active
            idle = 0.0 if pinned else max(t - self._last_touch.get(row, t),
                                          0.0)
            age = max(t - self._alloc_ts.get(row, t), 0.0)
            if idle <= hot_s:
                b = "hot"
            elif idle <= warm_s:
                b = "warm"
            else:
                b = "cold"
            buckets[b] += 1
            idles.append(idle)
            ages.append(age)
            owner = self._owner.get(row)
            key = owner[0] if owner else "unowned"
            trec = tenants.setdefault(key, {"pages": 0, "cold": 0})
            trec["pages"] += 1
            if b == "cold":
                trec["cold"] += 1
                if row in prefix:
                    cold_evictable += 1
                else:
                    cold_orphan += 1
            per_page.append((idle, row))
        per_page.sort(reverse=True)
        coldest = []
        for idle, row in per_page[:max(top_n, 0)]:
            owner = self._owner.get(row)
            coldest.append({
                "row": row,
                "idle_s": round(idle, 3),
                "age_s": round(max(t - self._alloc_ts.get(row, t), 0.0), 3),
                "touches": self._touch_count.get(row, 0),
                "refs": self._refs.get(row, 0),
                "tenant": owner[0] if owner else None,
                "class": owner[1] if owner else None,
                "prefix": row in prefix,
                "active": row in active,
            })
        rd = sorted(self._reuse_samples)
        if rd:
            # A page at stack distance d hits in a cache of d + 1 pages.
            wss = _percentile(rd, 0.90) + 1
        else:
            # No reuse seen yet: the recently touched set stands in.
            wss = buckets["hot"] + buckets["warm"]
        return {
            "t": t,
            "hot_s": hot_s,
            "warm_s": warm_s,
            "pages_total": self.n_pages - 1,
            "pages_in_use": self.pages_in_use,
            "free_pages": len(self._free),
            "buckets": buckets,
            "active_pages": len(active & self._refs.keys()),
            "prefix_pages": len(prefix & self._refs.keys()),
            "cold_evictable": cold_evictable,
            "cold_orphan": cold_orphan,
            "idle_s": _pct_summary(idles),
            "age_s": _pct_summary(ages),
            "idle_values": [round(v, 3) for v in idles],
            "tenants": tenants,
            "reuse_distance": {
                "samples": len(rd),
                "p50": _percentile(rd, 0.50) if rd else None,
                "p90": _percentile(rd, 0.90) if rd else None,
            },
            "working_set_pages": int(wss),
            "touches_total": self._touch_seq,
            "coldest": coldest,
        }


def _percentile(sorted_vals, q: float):
    """Nearest-rank percentile of an already sorted sequence."""
    if not sorted_vals:
        return None
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def _pct_summary(vals: list[float]) -> dict:
    s = sorted(vals)
    return {
        "p50": round(_percentile(s, 0.50), 3) if s else None,
        "p90": round(_percentile(s, 0.90), 3) if s else None,
        "max": round(s[-1], 3) if s else None,
    }


class PrefixIndex:
    """Host-side prefix cache over full prompt pages: a chain hash of
    page-aligned token blocks -> the pool row holding that page's K/V.
    Each entry holds its own allocator reference, so kept pages outlive
    the request that computed them, and a later request with the same
    prompt prefix shares the rows and skips their forward. LRU-bounded
    by `cap` entries; the engine also evicts under pool pressure.

    The chain hash (of (parent hash, page tokens)) makes a page's
    identity include its whole prefix. Entries keep the page's tokens
    and `match` compares them, so a 64-bit hash collision reads as a
    miss instead of attaching another prompt's pages.

    Thrash tracking: entries evicted under pressure are remembered with
    their eviction time (on the allocator's clock); a later `match` miss
    on one within `reref_horizon_s` counts as evicted-then-re-referenced
    (`rereferences`, `reref_ages`): the prefix would have hit had it
    stayed."""

    def __init__(self, alloc: PageAllocator, cap: int = 256,
                 reref_horizon_s: float = 30.0):
        self.alloc = alloc
        self.cap = cap
        # hash -> (pool row, page token tuple), least recent first
        self._lru: collections.OrderedDict[int, tuple[int, tuple]] = \
            collections.OrderedDict()
        self.reref_horizon_s = reref_horizon_s
        # hash -> eviction time, oldest first, bounded
        self._evicted: collections.OrderedDict[int, float] = \
            collections.OrderedDict()
        self._evicted_cap = max(4 * cap, 64)
        self.rereferences = 0
        # (time, seconds since eviction) of the latest rereferences
        self.reref_ages: collections.deque[tuple[float, float]] = \
            collections.deque(maxlen=256)

    @staticmethod
    def chain_keys(tokens, page: int,
                   n_full: int) -> list[tuple[int, tuple]]:
        """(chain hash, page tokens) per full page of the prompt."""
        keys, h = [], 0
        for i in range(n_full):
            block = tuple(tokens[i * page:(i + 1) * page])
            h = hash((h, block))
            keys.append((h, block))
        return keys

    def __len__(self) -> int:
        return len(self._lru)

    def match(self, keys: list[tuple[int, tuple]]) -> list[int]:
        """Pool rows of the longest indexed chain prefix, with one more
        reference taken on each (the caller owns them). A hash hit whose
        stored tokens differ stops the walk."""
        rows = []
        for h, block in keys:
            hit = self._lru.get(h)
            if hit is None or hit[1] != block:
                if hit is None and h in self._evicted:
                    ev_ts = self._evicted.pop(h)
                    now = self.alloc.clock()
                    age = max(now - ev_ts, 0.0)
                    if age <= self.reref_horizon_s:
                        self.rereferences += 1
                        self.reref_ages.append((now, age))
                break
            self._lru.move_to_end(h)
            rows.append(self.alloc.share(hit[0]))
        return rows

    def insert(self, key: tuple[int, tuple], row: int) -> None:
        h, block = key
        if h in self._lru:
            self._lru.move_to_end(h)
            return
        self._evicted.pop(h, None)
        self._lru[h] = (self.alloc.share(row), block)
        if len(self._lru) > self.cap:
            self.evict_lru()

    def rows_held(self) -> set[int]:
        """Distinct pool rows the index references (the prefix linkage
        the thermal census reports per page)."""
        return {row for row, _ in self._lru.values()}

    def pages_held(self) -> int:
        """Distinct pool rows the index references. After every request
        has finished these are the only pages in use, so
        `pages_in_use == pages_held()` says no page leaked."""
        return len(self.rows_held())

    def evict_lru(self) -> bool:
        """Drop the least recently used entry and its reference; False
        when empty."""
        if not self._lru:
            return False
        h, (row, _) = self._lru.popitem(last=False)
        self._evicted[h] = self.alloc.clock()
        while len(self._evicted) > self._evicted_cap:
            self._evicted.popitem(last=False)
        self.alloc.free([row])
        return True

    def clear(self) -> None:
        while self.evict_lru():
            pass
