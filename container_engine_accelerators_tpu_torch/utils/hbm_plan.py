"""Device-memory planner: does a (config, batch, cache) fit the card?
The port's own copy of the JAX package's tools/hbm_plan.py
`_layer_param_elems`, `plan_training` and `plan_serving`, with the same
arithmetic, so the plan a process was launched under reads the same in
either package for the same capacity.

It carries no device capacities. A plan's capacity is `hbm_bytes=`, or,
where that is not given, the card's own
(`torch.cuda.get_device_properties(device).total_memory`), and its
`chip` key names the card (torch.cuda.get_device_name) unless given.
The names say "hbm" as the JAX package's do; on the H100 it is HBM3.

The plan prices the JAX package's layouts (its shard factors, its
weight and cache bytes), not the port's exact allocations: the port pads
int8 weights for K2 (ops/quant.py) and the card's CUDA context and
caching allocator hold memory no plan counts. Serving records the plan
beside the process's peak allocation (introspection.set_expected_hbm).

Accounting (per device):

TRAINING
  state     = params f32 + mu + nu, sharded per the JAX package's
              llama_param_specs (d_model->fsdp, heads/ff/vocab->tp,
              layers->pp, experts->ep)
  grads     = one f32 params-sized tree (transient: the model takes
              max(activations + logits, grads), not their sum)
  acts      = remat='dots' saved dot outputs per layer per token, bf16,
              tokens sharded over dp*fsdp*sp, heads/ff over tp
  logits    = f32 logits + cross-entropy temporaries (x2)

SERVING
  weights   = the bf16 (or int8) decode copy: layers + lm_head over tp,
              embedding replicated
  kv        = the paged pool (pool_fraction of the slots x max_len
              reservation), KV heads over tp
"""

from __future__ import annotations

GB = 1e9


def _capacity(hbm_bytes: float | None, chip: str | None,
              device) -> tuple[float, str]:
    """(capacity in bytes, chip key): the arguments where given, else the
    card's."""
    if hbm_bytes is not None and chip is not None:
        return float(hbm_bytes), chip
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("no card to read a capacity from: pass hbm_bytes "
                         "and chip")
    props = torch.cuda.get_device_properties(dev)
    return (float(hbm_bytes) if hbm_bytes is not None
            else float(props.total_memory),
            chip if chip is not None else props.name)


def _layer_param_elems(cfg) -> tuple[int, int, int]:
    """(attn+norm elems, dense-mlp elems, moe elems) per layer."""
    hd = cfg.head_dim
    attn = (cfg.d_model * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            + 2 * cfg.d_model)
    n_experts = getattr(cfg, "n_experts", 0)
    if n_experts:
        moe = (n_experts * 3 * cfg.d_model * cfg.d_ff
               + cfg.d_model * n_experts)
        return attn, 0, moe
    return attn, 3 * cfg.d_model * cfg.d_ff, 0


def plan_training(cfg, *, dp=1, fsdp=1, pp=1, tp=1, sp=1, ep=1,
                  batch_size=1, seq_len=2048, mu_bytes=4,
                  chip: str | None = None, hbm_bytes: float | None = None,
                  device=None) -> dict:
    """Per-device memory breakdown for a training step (the JAX
    package's llama_param_specs shard factors)."""
    attn, mlp, moe = _layer_param_elems(cfg)
    L = cfg.n_layers
    # Global parameter count, then per device via each term's own shard
    # factor (one blanket multiplier would double-count vocab params
    # under pp/ep).
    vocab_total = 2 * cfg.vocab_size * cfg.d_model
    dense_total = L * (attn + mlp)
    moe_total = L * moe
    params_total = vocab_total + dense_total + moe_total + cfg.d_model
    p_chip = (vocab_total / (tp * fsdp)
              + dense_total / (pp * fsdp * tp)
              + moe_total / (pp * ep * fsdp * tp)
              + cfg.d_model)  # final_norm replicated
    state = p_chip * (4 + mu_bytes + 4)       # params f32 + mu + nu
    grads = p_chip * 4

    # Saved activations (dots policy), bf16, per token per layer: the
    # residual-stream saves are d_model wide and not tp-sharded; the qkv
    # and ff saves shard over tp.
    hd = cfg.head_dim
    n_experts = getattr(cfg, "n_experts", 0)
    top_k = getattr(cfg, "moe_top_k", 1) if n_experts else 1
    per_tok_layer = (3 * cfg.d_model
                     + (cfg.d_model + 2 * cfg.n_kv_heads * hd) / tp
                     + 2 * (cfg.d_ff * top_k) / tp)
    tokens_chip = batch_size * seq_len / (dp * fsdp * sp)
    acts = per_tok_layer * 2 * tokens_chip * L
    logits = tokens_chip * cfg.vocab_size / tp * 4 * 2  # + xent temps

    total = state + max(acts + logits, grads)
    cap, chip = _capacity(hbm_bytes, chip, device)
    return {
        "kind": "train", "chip": chip, "hbm_gb": round(cap / GB, 1),
        "mesh": {"dp": dp, "fsdp": fsdp, "pp": pp, "tp": tp, "sp": sp,
                 "ep": ep},
        "batch": batch_size, "seq": seq_len,
        "params_b": round(params_total / 1e9, 2),
        "state_gb": round(state / GB, 2),
        "grads_gb": round(grads / GB, 2),
        "acts_gb": round(acts / GB, 2),
        "logits_gb": round(logits / GB, 2),
        "total_gb": round(total / GB, 2),
        "headroom_gb": round((cap - total) / GB, 2),
        "fits": bool(total < cap),
    }


def plan_serving(cfg, *, tp=1, max_slots=8, max_len=4096,
                 pool_fraction=0.5, weight_bytes=2, kv_dtype="bf16",
                 weight_dtype="bf16", chip: str | None = None,
                 hbm_bytes: float | None = None, device=None,
                 host_tier_gb=0.0) -> dict:
    """Per-device memory for a serving deployment: the weights and the
    KV pool (pool_fraction of the full slots x max_len reservation; 1.0
    for the continuous engine's slots).

    kv_dtype 'int8' prices one byte a value plus an f32 scale per
    (token, head) for each of K and V; 'int4' half a byte a value with
    the same scales. weight_dtype 'int8' prices the projections and the
    lm_head at one byte a value plus an f32 scale per output channel;
    the embedding and norms stay bf16. `resident_slots` counts the fully
    backed max_len slots that fit in what the weights leave;
    host_tier_gb > 0 adds the slots a host-memory tier of that size
    would back beside it."""
    attn, mlp, moe = _layer_param_elems(cfg)
    L = cfg.n_layers
    embed = cfg.vocab_size * cfg.d_model          # replicated (decode)
    lm_head = cfg.vocab_size * cfg.d_model / tp
    moe_div = tp if (getattr(cfg, "n_experts", 0)
                     and getattr(cfg, "moe_decode_ep", False)) else 1
    layers = L * ((attn + mlp) / tp + moe / moe_div)
    if weight_dtype == "int8":
        q_bytes = 1 + 4 / cfg.d_model  # payload + per-out-channel f32
        weights = (embed * weight_bytes + (lm_head + layers) * q_bytes
                   + cfg.d_model * weight_bytes)
    else:
        weights = (embed + lm_head + layers + cfg.d_model) * weight_bytes

    hd = cfg.head_dim
    # Bytes per (token, head) of ONE of K or V: payload + scale plane.
    if kv_dtype == "int8":
        kv_tok_bytes = hd * 1 + 4
    elif kv_dtype == "int4":
        kv_tok_bytes = hd * 0.5 + 4
    else:
        kv_tok_bytes = hd * weight_bytes
    slot_kv = L * max_len * 2 * (cfg.n_kv_heads / tp) * kv_tok_bytes
    kv_full = max_slots * slot_kv
    kv = kv_full * pool_fraction
    total = weights + kv
    cap, chip = _capacity(hbm_bytes, chip, device)
    resident = int(max(cap - weights, 0) // slot_kv)
    out = {
        "kind": "serve", "chip": chip, "hbm_gb": round(cap / GB, 1),
        "tp": tp, "slots": max_slots, "max_len": max_len,
        "kv_dtype": kv_dtype, "weight_dtype": weight_dtype,
        "weights_gb": round(weights / GB, 2),
        "kv_pool_gb": round(kv / GB, 2),
        "total_gb": round(total / GB, 2),
        "headroom_gb": round((cap - total) / GB, 2),
        "resident_slots": resident,
        "fits": bool(total < cap),
    }
    if host_tier_gb > 0:
        kv_bytes_hbm = max(cap - weights, 0)
        with_tier = int(
            (kv_bytes_hbm + host_tier_gb * GB) // slot_kv)
        out["host_tier_gb"] = host_tier_gb
        out["resident_slots_with_tier"] = with_tier
        out["tier_slot_multiplier"] = round(
            (kv_bytes_hbm + host_tier_gb * GB)
            / max(kv_bytes_hbm, 1.0), 2)
    return out
