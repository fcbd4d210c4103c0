"""Incremental decoding with a KV cache: the serving path's model code.

The cache is a preallocated [L, B, max_len, Hkv, D] pair of tensors,
written in place (the JAX package donates and rebuilds it; here the
update is a slice or index assignment). `decode_step` runs T new tokens
through embed, per layer RMSNorm, q/k/v projections, RoPE at absolute
positions, the cache write, cached attention, wo plus residual, RMSNorm,
SwiGLU plus residual, then the final norm and f32 logits. Attention goes
through ops/decode_attention (the CUDA kernel on the card), and int8
QuantWeight projections through ops/quant.int8_matmul.

Nothing here synchronises with the device, so `generate` returns as soon
as its work is queued; the serving engine fetches the tokens later.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
)
from container_engine_accelerators_tpu_torch.ops import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from container_engine_accelerators_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from container_engine_accelerators_tpu_torch.ops.quant import (
    QuantWeight,
    int8_matmul,
    int8_matmul_plain,
)


@dataclasses.dataclass(frozen=True)
class KVCache:
    k: torch.Tensor        # [L, B, max_len, Hkv, D]
    v: torch.Tensor        # [L, B, max_len, Hkv, D]
    # Tokens already cached: an int shared by every row (the batched
    # path; host-known, so writes are plain slices), or a [B] int32
    # tensor on the device (per-slot lengths).
    length: int | torch.Tensor


def _check_kv_dtype(cfg: LlamaConfig):
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported yet; "
            "this slice stores the cache in cfg.dtype ('bf16')")


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: str | torch.device) -> KVCache:
    """Zeroed cache in cfg.dtype."""
    _check_kv_dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   length=0)


def init_slot_cache(cfg: LlamaConfig, slots: int, max_len: int,
                    device: str | torch.device) -> KVCache:
    """KVCache with per-slot lengths ([slots] int32, all zero)."""
    cache = init_cache(cfg, slots, max_len, device)
    return dataclasses.replace(
        cache, length=torch.zeros(slots, dtype=torch.int32, device=device))


def _proj(h: torch.Tensor, w, plain: bool) -> torch.Tensor:
    if isinstance(w, QuantWeight):
        matmul = int8_matmul_plain if plain else int8_matmul
        out = matmul(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], -1)
    return h @ w


def decode_step(model: Llama, cache: KVCache, tokens: torch.Tensor,
                cfg: LlamaConfig, active: torch.Tensor | None = None,
                plain: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Run T new tokens ([B, T]; T = prompt length for prefill, 1 for
    decode). Returns (logits [B, T, vocab] f32, cache with the new K/V
    written in place and the lengths advanced).

    With per-slot lengths, row b writes at min(length[b], max_len - T)
    and `active` ([B] bool) gates which rows' lengths advance; inactive
    rows still compute and write where the next prefill overwrites.
    `plain=True` runs the kernels' plain PyTorch versions on any device
    (the on-card reference for the kernel path)."""
    _check_kv_dtype(cfg)
    b, t = tokens.shape
    dev = tokens.device
    max_len = cache.k.shape[2]
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
    attention = decode_attention_plain if plain else decode_attention

    x = model.embed[tokens]
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        q = _proj(h, layer.wq, plain).reshape(b, t, -1, hd)
        k = _proj(h, layer.wk, plain).reshape(b, t, -1, hd)
        v = _proj(h, layer.wv, plain).reshape(b, t, -1, hd)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        k_cache, v_cache = cache.k[li], cache.v[li]
        if per_slot:
            k_cache[rows, positions] = k.to(k_cache.dtype)
            v_cache[rows, positions] = v.to(v_cache.dtype)
        else:
            k_cache[:, cache.length:cache.length + t] = k.to(k_cache.dtype)
            v_cache[:, cache.length:cache.length + t] = v.to(v_cache.dtype)
        attn = attention(q.to(dt), k_cache, v_cache, att_len)
        x = x + _proj(attn.reshape(b, t, -1), layer.wo, plain)
        h2 = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
        gate = F.silu(_proj(h2, layer.w_gate, plain))
        up = _proj(h2, layer.w_up, plain)
        x = x + _proj(gate * up, layer.w_down, plain)

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    # The vocab projection is a true f32 product (TF32 stays off).
    logits = _proj(x.float(), model.lm_head, plain)

    if per_slot:
        new_len = (cache.length + t).clamp(max=max_len)
        if active is not None:
            new_len = torch.where(active, new_len, cache.length)
        new_len = new_len.to(torch.int32)
    else:
        new_len = cache.length + t
    return logits, dataclasses.replace(cache, length=new_len)


def decode_step_slots(model: Llama, cache: KVCache, tokens: torch.Tensor,
                      active: torch.Tensor, cfg: LlamaConfig
                      ) -> tuple[torch.Tensor, KVCache]:
    """One decode step for every slot: tokens [B], active [B] bool.
    Returns (last-token logits [B, vocab] f32, cache)."""
    logits, cache = decode_step(model, cache, tokens[:, None], cfg,
                                active=active)
    return logits[:, 0], cache


def _sample(logits: torch.Tensor, generator: torch.Generator | None
            ) -> torch.Tensor:
    """One categorical draw per row of `logits` [B, V]."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
             plain: bool = False) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation. prompt: [B, T0]
    integer tokens. Returns [B, T0 + max_new_tokens] int64 on the
    prompt's device, without waiting for the device.

    The cache holds T0 + max_new_tokens positions. Unlike the JAX
    package, that length is not rounded up to a multiple of 128: the
    padding existed for the TPU kernel's tiling; the CUDA kernel takes
    any length, and padding would only add masked slots that change no
    token. Sampling draws from `generator` (a fixed seed when None), so
    a seed gives the same tokens on the same device; the draws are not
    jax.random's."""
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
