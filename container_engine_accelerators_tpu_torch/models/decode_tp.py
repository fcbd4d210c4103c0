"""Tensor-parallel serving: the decode path sharded Megatron-style over a
group of rank processes, as the JAX package's `models/decode_tp.py`
shards it over a 'tp' mesh axis.

The layout is the JAX package's (`decode_shard_plan`, its
`decode_param_specs`):
  - wq/wk/wv and w_gate/w_up split by output column (each rank holds
    n_heads/tp query heads, n_kv_heads/tp KV heads, d_ff/tp FFN lanes);
    wo and w_down split by input row; the lm_head by vocab; the
    embedding and the norms whole on every rank;
  - int8 weights (QuantWeight) keep per-output-channel scales that
    follow the output axis: a column shard holds its channels' scales, a
    row shard the whole weight's;
  - a mixture of experts keeps its experts whole on every rank, or,
    under cfg.moe_decode_ep, splits them on the expert axis (E/tp a
    rank); the router stays whole;
  - the KV cache holds this rank's KV heads (`cache_layout`); lengths
    and page tables are whole on every rank.
Activations stay replicated, so a layer costs two all_reduces (after wo
and after w_down) and a step one vocab all-gather of the logits, all
inserted by models/decode.py's `tp` hooks; the kernels see local shapes.

The rank runtime has no counterpart in JAX, where one process drives
every chip. Here each rank is a process: rank 0 (`TPRuntime`) runs the
serving engines and spawns ranks 1..tp-1, which run `follower_loop`.
Every operation on the model or the cache leaves rank 0 as a message
holding the operation and its host-side arguments (tokens, active rows,
slot, page rows, counts), sent to each follower over its own socket;
then every rank runs it on its own shard, the collectives inside it
keeping the ranks in step. The cache mutations (set_slot_pages,
assign_pages, advance_lengths, a cache's allocation and release) are
operations too. One lock on rank 0 covers each message and the run that
follows it, so every rank issues the same collectives in the same
order. Rank 0 alone samples, from the gathered logits. A follower dies
with rank 0 (its socket closes, and on Linux the parent-death signal
kills it), and rank 0 watches its followers: when one exits, the
runtime is dead, every later operation raises, and `on_death` callbacks
run (serve fails its requests and exits).

Placement (parallel/distributed.tp_placement): rank r on cuda:r over
NCCL where the process sees at least tp cards; every rank on cuda:0 over
gloo where it sees fewer; gloo on the CPU when asked for. The group's
collectives time out after `timeout_s`; an idle follower waits on its
socket, not on a collective, so idling never times out.

  rt = TPRuntime(2, device="cuda")
  model = rt.random_model(llama3_8b(), seed=0)   # rank 0's shard
  out = rt.generate(model, prompt, cfg, 32)
  rt.close()

`python -m container_engine_accelerators_tpu_torch.models.decode_tp
--follower ...` is a follower's entry point; TPRuntime starts it.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import itertools
import logging
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
import weakref
from multiprocessing.connection import Connection
from pathlib import Path

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.models import decode as dec
from container_engine_accelerators_tpu_torch.models import spec
from container_engine_accelerators_tpu_torch.models.convert import (
    checkpoint_weights,
    serving_model,
)
from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    _random_llama,
    decode_dtype,
    layer_weights,
)
from container_engine_accelerators_tpu_torch.ops.quant import (
    QUANT_KEYS,
    QuantWeight,
    quantize_weights,
)
from container_engine_accelerators_tpu_torch.parallel.distributed import (
    TPGroup,
    init_tp_group,
    tp_placement,
)

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 60.0
# Seconds a follower has to import torch and say hello before rank 0
# gives up on it.
START_TIMEOUT_S = 120.0
FOLLOWER_MODULE = "container_engine_accelerators_tpu_torch.models.decode_tp"
_ROOT = Path(__file__).resolve().parents[2]


def validate_tp(cfg: LlamaConfig, tp: int) -> None:
    """The JAX package's check: tp divides the head counts, d_ff and the
    vocabulary, and the experts under moe_decode_ep."""
    if tp <= 1:
        return
    bad = [name for name, dim in [
        ("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
        ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)]
        if dim % tp]
    if bad:
        raise ValueError(
            f"tp={tp} must divide {bad} (cfg: n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}, d_ff={cfg.d_ff}, "
            f"vocab_size={cfg.vocab_size})")
    if cfg.n_experts and cfg.moe_decode_ep and cfg.n_experts % tp:
        raise ValueError(
            f"moe_decode_ep shards experts over tp: tp={tp} must "
            f"divide n_experts={cfg.n_experts} (or replicate experts "
            f"with moe_decode_ep=False)")


# ---------- the shard plan ----------

def decode_shard_plan(cfg: LlamaConfig) -> dict:
    """Which axis of each weight splits over tp (None: whole on every
    rank), for the port's [in, out] weights: {"embed", "final_norm",
    "lm_head", "layers": {name: axis}}. The counterpart of the JAX
    package's decode_param_specs, whose stacked [L, ...] layer weights
    put the same split one axis further on. A QuantWeight's scales
    split with its values only where the values split on their last
    (output) axis."""
    if cfg.n_experts:
        ffn = {"w_router": None,
               **{n: 0 if cfg.moe_decode_ep else None
                  for n in ("w_gate", "w_up", "w_down")}}
    else:
        ffn = {"w_gate": 1, "w_up": 1, "w_down": 0}
    layers = {"attn_norm": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0,
              "mlp_norm": None, **ffn}
    return {"embed": None, "final_norm": None, "lm_head": 1,
            "layers": {n: layers[n] for n in layer_weights(cfg)}}


def _shard(w, axis: int | None, rank: int, tp: int):
    """Rank `rank`'s part of weight w split over `tp` on `axis` (a
    contiguous copy; None keeps w whole and shared)."""
    if axis is None or tp == 1:
        return w
    if isinstance(w, QuantWeight):
        out_axis = w.values.ndim - 1
        scales = (_shard(w.scales, w.scales.ndim - 1, rank, tp)
                  if axis % w.values.ndim == out_axis else w.scales)
        return QuantWeight(_shard(w.values, axis, rank, tp), scales)
    n = w.shape[axis] // tp
    return w.detach().narrow(axis, rank * n, n).contiguous()


def shard_decode_params(model: Llama, rank: int, tp: int,
                        cfg: LlamaConfig | None = None) -> Llama:
    """Rank `rank`'s local Llama of a whole model (bf16 or QuantWeight)
    in the decode tp layout; `cfg` (default model.cfg) picks the expert
    layout. Its cfg stays the whole model's."""
    cfg = cfg or model.cfg
    validate_tp(cfg, tp)
    plan = decode_shard_plan(cfg)
    layers = [LlamaLayer(**{n: _shard(getattr(layer, n), axis, rank, tp)
                            for n, axis in plan["layers"].items()})
              for layer in model.layers]
    return Llama(cfg, embed=model.embed, layers=layers,
                 final_norm=model.final_norm,
                 lm_head=_shard(model.lm_head, plan["lm_head"], rank, tp))


def _weight_axes(cfg: LlamaConfig) -> dict:
    """{short weight name: split axis} of decode_shard_plan, flat."""
    plan = decode_shard_plan(cfg)
    return {**plan["layers"], "embed": None, "final_norm": None,
            "lm_head": plan["lm_head"]}


def init_params_shard(cfg: LlamaConfig, seed: int, device, rank: int,
                      tp: int) -> Llama:
    """Rank `rank`'s shard of models.llama.init_params(cfg, a generator
    seeded `seed` on `device`): every weight is drawn whole, in
    init_params' order, and only this rank's part is kept, one weight
    at a time, so a rank never holds the whole model and its values
    equal the tp 1 model's."""
    validate_tp(cfg, tp)
    axes = _weight_axes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _random_llama(
        cfg, gen, device, lambda name: decode_dtype(cfg, name),
        trainable=False,
        keep=lambda name, w: _shard(w, axes[name], rank, tp))


def quantize_shard(model: Llama, tp: TPGroup | None) -> Llama:
    """ops/quant.quantize_llama_params of a rank's shard, giving the
    shard of the whole model's quantization: a column shard holds
    whole output channels, so its scales are its own; a row shard holds
    some rows of each channel, so its absmax is the maximum over the
    group (an all_gather of the local absmax)."""
    plan = decode_shard_plan(model.cfg)

    def group_max(absmax):
        if tp is None or tp.size == 1:
            return absmax
        parts = [torch.empty_like(absmax) for _ in range(tp.size)]
        dist.all_gather(parts, absmax.contiguous(), group=tp.group)
        return torch.stack(parts).amax(dim=0)

    def quantize(w, axis):
        return quantize_weights(w, group_max if axis == 0 else None)

    layers = []
    for layer in model.layers:
        weights = {n: getattr(layer, n) for n in layer_weights(model.cfg)}
        weights.update({n: quantize(weights[n], plan["layers"][n])
                        for n in QUANT_KEYS})
        layers.append(LlamaLayer(**weights))
    return Llama(model.cfg, embed=model.embed, layers=layers,
                 final_norm=model.final_norm,
                 lm_head=quantize(model.lm_head, plan["lm_head"]))


# ---------- the cache's layout ----------

def cache_layout(paged: bool, quantized: bool = False) -> dict:
    """Which axis of each cache field splits over tp (None: whole on
    every rank), the counterpart of the JAX package's cache_specs: K/V
    on their KV-head axis, the scale planes on theirs, lengths and page
    tables whole."""
    kv, sc = 3, (2 if quantized else None)
    if paged:
        return {"k_pool": kv, "v_pool": kv, "tables": None, "length": None,
                "k_scales": sc, "v_scales": sc}
    return {"k": kv, "v": kv, "length": None, "k_scales": sc, "v_scales": sc}


def local_cache_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """cfg with a rank's KV heads, for the cache allocations (head_dim,
    which reads n_heads, stays the model's)."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp)


def init_sharded_cache(init, cfg: LlamaConfig, tp: int, *args, **kwargs):
    """A fresh cache allocated directly in the tp layout: `init` (e.g.
    models.decode.init_slot_cache) called with cfg narrowed to this
    rank's KV heads, so no rank ever holds the whole cache."""
    return init(local_cache_cfg(cfg, tp), *args, **kwargs)


# ---------- one rank's state and its operations ----------

@dataclasses.dataclass
class RankState:
    """What a rank holds: its group, and its models and caches by name.
    Rank 0 keeps no caches here: its operations are handed the caches
    its caller holds, so a cache lives as long as the caller keeps it
    (TPRuntime then has the followers drop theirs)."""
    tp: TPGroup
    keep_caches: bool = True
    models: dict = dataclasses.field(default_factory=dict)
    caches: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.tp.device

    def tensor(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.device)

    def cache(self, name: str, given=None):
        return self.caches[name] if given is None else given

    def put(self, name: str, cache):
        if self.keep_caches:
            self.caches[name] = cache
        return cache


def _op_model_random(st, name, cfg, seed):
    st.models[name] = init_params_shard(cfg, seed, st.device, st.tp.rank,
                                        st.tp.size)


def _op_model_checkpoint(st, name, path, cfg_fields):
    """Each weight of the checkpoint read on the host one at a time and
    cut to this rank's shard before it goes to the device; a shard that
    is a run of the file's rows (a column shard of a transposed HF
    weight) is all that is read of it."""
    weights, cfg = checkpoint_weights(path)
    cfg = dataclasses.replace(cfg, **cfg_fields)
    validate_tp(cfg, st.tp.size)
    axes = _weight_axes(cfg)
    st.models[name] = serving_model(
        weights, cfg, st.device,
        read=lambda n: weights.part(n, axes[n.rsplit(".", 1)[-1]],
                                    st.tp.rank, st.tp.size))
    return cfg


def _op_model_weights(st, name, cfg, weights):
    """A whole model sent as host tensors (state_dict form): this rank
    keeps its shard."""
    whole = _llama_from_state(cfg, weights)
    st.models[name] = shard_decode_params(
        whole, st.tp.rank, st.tp.size, cfg).to(st.device)


def _op_model_quantize(st, src, dst):
    st.models[dst] = quantize_shard(st.models[src], st.tp)


def _op_model_truncate(st, src, dst, n_layers):
    st.models[dst] = spec.truncate_params(st.models[src], n_layers)


def _op_drop(st, models, caches):
    for name in models:
        st.models.pop(name, None)
    for name in caches:
        st.caches.pop(name, None)


def _op_cache_init(st, name, kind, cfg, args):
    init = {"slot": dec.init_slot_cache, "paged": dec.init_paged_cache,
            "contiguous": dec.init_cache}[kind]
    st.caches.pop(name, None)   # the old one goes first
    return st.put(name, init_sharded_cache(init, cfg, st.tp.size, *args,
                                           st.device))


def _op_decode_step(st, m, c, tokens, active, plain, advance, cache=None):
    model = st.models[m]
    logits, cache = dec.decode_step(
        model, st.cache(c, cache), st.tensor(tokens, torch.long), model.cfg,
        active=None if active is None else st.tensor(active, torch.bool),
        plain=plain, advance=advance, tp=st.tp)
    return logits, st.put(c, cache)


def _op_decode_step_slots(st, m, c, tokens, active, plain, paged,
                          cache=None):
    model = st.models[m]
    fn = dec.decode_step_paged if paged else dec.decode_step_slots
    logits, cache = fn(model, st.cache(c, cache),
                       st.tensor(tokens, torch.long),
                       st.tensor(active, torch.bool), model.cfg,
                       plain=plain, tp=st.tp)
    return logits, st.put(c, cache)


def _op_prefill_slot(st, m, c, slot, rows, tokens, true_len, plain,
                     cache=None):
    model = st.models[m]
    toks = st.tensor(tokens, torch.long)
    if rows is None:
        logits, cache = dec.prefill_slot(model, st.cache(c, cache), slot,
                                         toks, true_len, model.cfg,
                                         plain=plain, tp=st.tp)
    else:
        logits, cache = dec.prefill_slot_paged(
            model, st.cache(c, cache), slot, st.tensor(rows, torch.int32),
            toks, true_len, model.cfg, plain=plain, tp=st.tp)
    return logits, st.put(c, cache)


def _op_prefill_suffix(st, m, c, slot, tokens, start, new_len, plain,
                       cache=None):
    model = st.models[m]
    toks = st.tensor(tokens, torch.long)
    if start is None:
        logits, cache = dec.prefill_suffix_paged(
            model, st.cache(c, cache), slot, toks, new_len, model.cfg,
            plain=plain, tp=st.tp)
    else:
        logits, cache = dec.prefill_suffix_slot(
            model, st.cache(c, cache), slot, toks, start, new_len,
            model.cfg, plain=plain, tp=st.tp)
    return logits, st.put(c, cache)


def _op_advance_lengths(st, c, counts, active, cache=None):
    return st.put(c, dec.advance_lengths(
        st.cache(c, cache), st.tensor(counts, torch.int32),
        None if active is None else st.tensor(active, torch.bool)))


def _op_copy_lengths(st, dst, src, dst_cache=None, src_cache=None):
    return st.put(dst, dataclasses.replace(
        st.cache(dst, dst_cache),
        length=st.cache(src, src_cache).length.clone()))


def _op_set_slot_pages(st, c, slot, rows, length, cache=None):
    return st.put(c, dec.set_slot_pages(
        st.cache(c, cache), slot, st.tensor(rows, torch.int32), length))


def _op_assign_pages(st, c, page_pos, rows, mask, cache=None):
    return st.put(c, dec.assign_pages(
        st.cache(c, cache), st.tensor(page_pos, torch.long),
        st.tensor(rows, torch.int32), st.tensor(mask, torch.bool)))


def _op_generate(st, m, prompt, n_new, temperature, plain, generator=None):
    """Rank 0 samples with `generator`; the followers never sample."""
    model = st.models[m]
    return dec.generate(model, st.tensor(prompt, torch.long), model.cfg,
                        n_new, temperature=temperature, generator=generator,
                        plain=plain, tp=st.tp)


def _op_stats(st, reset_launches, reset_peak):
    """This rank's pid, device, kernel launches and peak memory."""
    from container_engine_accelerators_tpu_torch import kernels

    dev = st.device
    out = {"rank": st.tp.rank, "pid": os.getpid(), "device": str(dev),
           "backend": st.tp.backend, "launches": dict(kernels.launches),
           "models": sorted(st.models), "caches": sorted(st.caches)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
            dev)
        out["memory_allocated_bytes"] = torch.cuda.memory_allocated(dev)
        if reset_peak:
            torch.cuda.reset_peak_memory_stats(dev)
    if reset_launches:
        kernels.reset_launches()
    return out


def _op_check_kernels(st, m, qm, seed, slots, chunk_len, row_floor):
    """K1, K3 and K2 at this rank's local shapes against their plain
    versions: a `chunk_len` prefill chunk, then a `slots`-slot decode
    step, of model `m` on a slot cache and on a page pool (page 128) and
    of int8 model `qm` on a slot cache, the first call of each kernel at
    each shape run again by its plain version on the same inputs.
    Returns {case: {"shape", "max_abs_err", "rel_err"}}: for K1 and K3
    the largest row error over that row's max |o| plus `row_floor`, for
    K2 the error over max |y| (also given, with x's dtype). The caller
    holds them to its bounds."""
    from container_engine_accelerators_tpu_torch.ops import (
        decode_attention as da,
    )
    from container_engine_accelerators_tpu_torch.ops import quant

    dev = st.device
    plains = {"decode_attention": da.decode_attention_plain,
              "paged_decode_attention": da.paged_decode_attention_plain,
              "int8_matmul": quant.int8_matmul_plain}
    seen, out = set(), {}

    def held(name, args, got):
        want = plains[name](*args).float()
        got = got.float()
        if name == "int8_matmul":
            err = (got - want).abs().max().item()
            top = want.abs().max().item()
            return {"shape": [list(args[0].shape),
                              list(args[1].values.shape)],
                    "x_dtype": ("f32" if args[0].dtype == torch.float32
                                else "bf16"),
                    "max_abs_err": err, "max_abs_y": top,
                    "rel_err": err / top}
        d = args[0].shape[-1]
        row_err = (got - want).abs().reshape(-1, d).amax(-1)
        row_scale = want.abs().reshape(-1, d).amax(-1)
        return {"shape": [list(args[0].shape), list(args[1].shape)],
                "max_abs_err": row_err.max().item(),
                "rel_err": (row_err / (row_scale + row_floor)).max().item()}

    def recording(name, fn, tag):
        def call(*args):
            res = fn(*args)
            key = (name, tag, tuple(tuple(a.shape) for a in args[:2]
                                    if hasattr(a, "shape")),
                   getattr(args[0], "dtype", None))
            if key not in seen:
                seen.add(key)
                shape = "x".join(str(x) for x in args[0].shape)
                out[f"{name}:{tag}:{shape}:{len(seen)}"] = held(name, args,
                                                                res)
            return res
        return call

    gen = torch.Generator(device="cpu").manual_seed(seed)
    orig = {n: getattr(dec, n) for n in plains}
    try:
        for tag, model in (("bf16", st.models[m]), ("int8", st.models[qm])):
            for n, fn in orig.items():
                setattr(dec, n, recording(n, fn, tag))
            cfg = model.cfg
            chunk = torch.randint(0, cfg.vocab_size, (chunk_len,),
                                  generator=gen).to(dev)
            step = torch.randint(0, cfg.vocab_size, (slots,),
                                 generator=gen).to(dev)
            on = torch.ones(slots, dtype=torch.bool, device=dev)
            cache = init_sharded_cache(dec.init_slot_cache, cfg, st.tp.size,
                                       slots, 2 * chunk_len, dev)
            dec.prefill_suffix_slot(model, cache, 0, chunk, 0, chunk_len,
                                    cfg, tp=st.tp)
            dec.decode_step_slots(model, cache, step, on, cfg, tp=st.tp)
            del cache
            if tag == "bf16":
                page = 128
                pages = 2 * chunk_len // page
                pool = init_sharded_cache(dec.init_paged_cache, cfg,
                                          st.tp.size, slots,
                                          slots * pages + 1, page, pages,
                                          dev)
                for s in range(slots):
                    dec.set_slot_pages(pool, s, torch.arange(
                        1 + s * pages, 1 + (s + 1) * pages,
                        dtype=torch.int32, device=dev), 0)
                dec.prefill_suffix_paged(model, pool, 0, chunk, chunk_len,
                                         cfg, tp=st.tp)
                dec.decode_step_paged(model, pool, step, on, cfg, tp=st.tp)
                del pool
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        for n, fn in orig.items():
            setattr(dec, n, fn)
    return out


OPS = {
    "model_random": _op_model_random,
    "model_checkpoint": _op_model_checkpoint,
    "model_weights": _op_model_weights,
    "model_quantize": _op_model_quantize,
    "model_truncate": _op_model_truncate,
    "drop": _op_drop,
    "cache_init": _op_cache_init,
    "decode_step": _op_decode_step,
    "decode_step_slots": _op_decode_step_slots,
    "prefill_slot": _op_prefill_slot,
    "prefill_suffix": _op_prefill_suffix,
    "advance_lengths": _op_advance_lengths,
    "copy_lengths": _op_copy_lengths,
    "set_slot_pages": _op_set_slot_pages,
    "assign_pages": _op_assign_pages,
    "generate": _op_generate,
    "stats": _op_stats,
    "check_kernels": _op_check_kernels,
}


def _llama_from_state(cfg: LlamaConfig, weights: dict) -> Llama:
    """A Llama from {name: tensor} in Llama.state_dict()'s naming."""
    layers = []
    for i in range(cfg.n_layers):
        kw = {}
        for n in layer_weights(cfg):
            if f"layers.{i}.{n}.values" in weights:
                kw[n] = QuantWeight(weights[f"layers.{i}.{n}.values"],
                                    weights[f"layers.{i}.{n}.scales"])
            else:
                kw[n] = weights[f"layers.{i}.{n}"]
        layers.append(LlamaLayer(**kw))
    head = (QuantWeight(weights["lm_head.values"], weights["lm_head.scales"])
            if "lm_head.values" in weights else weights["lm_head"])
    return Llama(cfg, embed=weights["embed"], layers=layers,
                 final_norm=weights["final_norm"], lm_head=head)


# ---------- the local operations (tp 1) ----------

class LocalOps:
    """The operations the serving engines call, on one process: the
    models.decode functions themselves (looked up at each call), under
    TPRuntime's interface."""

    size = 1
    # TPRuntime's names that models.decode has under the same name.
    DECODE = ("decode_step", "decode_step_slots", "decode_step_paged",
              "prefill_slot", "prefill_slot_paged", "prefill_suffix_slot",
              "prefill_suffix_paged", "verify_step", "advance_lengths",
              "set_slot_pages", "assign_pages", "init_cache",
              "init_slot_cache", "init_paged_cache", "generate")

    def __getattr__(self, name):
        if name in self.DECODE:
            return getattr(dec, name)
        raise AttributeError(name)

    @staticmethod
    def truncate_params(model, n_layers):
        return spec.truncate_params(model, n_layers)

    @staticmethod
    def copy_lengths(dst, src):
        """dst with src's lengths (the draft cache's re-anchor)."""
        return dataclasses.replace(dst, length=src.length.clone())


LOCAL = LocalOps()


# ---------- rank 0 ----------

def _host(x):
    """A host-side argument: tensors as nested lists (the values a
    follower needs), anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return x


def _send(conn: Connection, obj) -> None:
    """Plain pickles: multiprocessing's own pickler would pass tensors
    as shared-memory handles, which a process it did not start cannot
    open."""
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn: Connection):
    return pickle.loads(conn.recv_bytes())


def _storage(cache):
    return cache.k_pool if isinstance(cache, dec.PagedKVCache) else cache.k


def _set_pdeathsig() -> None:
    """Linux: this process gets SIGKILL when its parent dies, so no
    follower outlives the rank 0 that spawned it."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG


class TPRuntime:
    """Rank 0 of a tensor-parallel serving group: spawns ranks
    1..tp-1 (each `follower_loop` in a process of its own), joins the
    group, and runs every operation on every rank (see the module
    docstring). Its methods take and return what models.decode's do:
    rank 0's model shard and caches, and the whole [.., vocab] logits.

    `device` 'cuda' places the ranks by tp_placement; 'cpu' runs gloo on
    the CPU. `threads` sets the followers' torch threads (default: this
    process's). Callbacks in `on_death` get the error once when a
    follower exits before close()."""

    def __init__(self, tp: int, device="cuda", timeout_s: float =
                 DEFAULT_TIMEOUT_S, threads: int | None = None):
        if tp < 2:
            raise ValueError(f"a TPRuntime needs tp >= 2, got {tp}")
        if dist.is_initialized():
            raise RuntimeError("this process is already in a process "
                               "group; a TPRuntime makes its own")
        self.size = tp
        self.timeout_s = timeout_s
        self.backend, self.devices = tp_placement(tp, device)
        self.dead: str | None = None
        self.on_death: list = []
        self._closing = False
        self._lock = threading.RLock()
        self._names = itertools.count(1)
        self._drops: collections.deque = collections.deque()
        self.procs: list[subprocess.Popen] = []
        self._conns: list[Connection] = []
        t0 = time.monotonic()
        store = dist.TCPStore("127.0.0.1", 0, tp, is_master=True,
                              timeout=datetime.timedelta(seconds=timeout_s),
                              wait_for_workers=False)
        try:
            self._spawn(store.port, threads or torch.get_num_threads())
            self.tp = init_tp_group(0, tp, store, self.backend,
                                    self.devices[0], timeout_s)
        except BaseException:
            self._kill()
            raise
        self.state = RankState(self.tp, keep_caches=False)
        self.start_s = time.monotonic() - t0
        log.info("tp group of %d up in %.1fs: %s, devices %s, follower "
                 "pids %s", tp, self.start_s, self.backend,
                 [str(d) for d in self.devices],
                 [p.pid for p in self.procs])
        self._watch = threading.Thread(target=self._watchdog, daemon=True,
                                       name="tp-watchdog")
        self._watch.start()

    # ----- processes -----

    def _spawn(self, store_port: int, threads: int) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        for rank in range(1, self.size):
            mine, theirs = socket.socketpair()
            proc = subprocess.Popen(
                [sys.executable, "-m", FOLLOWER_MODULE, "--follower",
                 "--rank", str(rank), "--tp", str(self.size),
                 "--store-port", str(store_port),
                 "--backend", self.backend,
                 "--device", str(self.devices[rank]),
                 "--timeout", str(self.timeout_s),
                 "--threads", str(threads), "--fd", str(theirs.fileno()),
                 "--parent", str(os.getpid())],
                pass_fds=(theirs.fileno(),), env=env, cwd=str(_ROOT))
            theirs.close()
            self.procs.append(proc)
            self._conns.append(Connection(mine.detach()))
        # Each follower says hello once torch is imported, before it
        # joins the group: one that dies starting is named here rather
        # than found by the group's timeout.
        deadline = time.monotonic() + START_TIMEOUT_S
        for rank, (proc, conn) in enumerate(zip(self.procs, self._conns),
                                            start=1):
            while not conn.poll(0.1):
                if proc.poll() is not None:
                    raise RuntimeError(f"tp rank {rank} exited with code "
                                       f"{proc.returncode} while starting")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"tp rank {rank} did not start "
                                       f"within {START_TIMEOUT_S}s")
            _recv(conn)

    def _watchdog(self) -> None:
        while not self._closing:
            for rank, proc in enumerate(self.procs, start=1):
                if proc.poll() is not None and not self._closing:
                    self._die(f"tp rank {rank} (pid {proc.pid}) exited "
                              f"with code {proc.returncode}")
                    return
            time.sleep(0.1)

    def _die(self, why: str) -> None:
        if self.dead is not None:
            return
        self.dead = why
        log.error("tensor-parallel group lost: %s", why)
        err = RuntimeError(f"tensor-parallel group lost: {why}")
        for fn in list(self.on_death):
            try:
                fn(err)
            except Exception:   # noqa: BLE001 - every callback runs
                log.exception("tp on_death callback failed")

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            proc.wait(timeout=30)

    def close(self) -> None:
        """Stop the followers (each leaves the group and exits) and leave
        the group. A follower still running after the timeout is
        killed."""
        if self._closing:
            return
        self._closing = True
        with self._lock:
            if self.dead is None:
                for conn in self._conns:
                    try:
                        _send(conn, ("exit", (), False))
                    except OSError:
                        pass
            deadline = time.monotonic() + self.timeout_s
            for proc in self.procs:
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
            for conn in self._conns:
                conn.close()
            if dist.is_initialized():
                dist.destroy_process_group()
        self._watch.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----- the operation protocol -----

    def call(self, op: str, *args, reply: bool = False, local=None):
        """Run OPS[op](state, *args) on every rank: the message goes to
        every follower, then rank 0 runs it, with `local` (keyword
        arguments only rank 0 gets: the caches its caller holds, the
        sampling generator). Returns rank 0's result, or with `reply`
        every rank's in rank order."""
        with self._lock:
            if self.dead is not None:
                raise RuntimeError(f"tensor-parallel group lost: "
                                   f"{self.dead}")
            drops = []
            while self._drops:
                drops.append(self._drops.popleft())
            msgs = ([("drop", ((), drops), False)] if drops else []) + [
                (op, args, reply)]
            try:
                for msg in msgs:
                    for conn in self._conns:
                        _send(conn, msg)
            except OSError as e:
                self._die(f"a follower's socket failed: {e}")
                raise RuntimeError(f"tensor-parallel group lost: "
                                   f"{self.dead}") from e
            result = OPS[op](self.state, *args, **(local or {}))
            if not reply:
                return result
            out = [result]
            for rank, conn in enumerate(self._conns, start=1):
                try:
                    status, value = _recv(conn)
                except (EOFError, OSError) as e:
                    self._die(f"tp rank {rank} closed its socket")
                    raise RuntimeError(f"tensor-parallel group lost: "
                                       f"{self.dead}") from e
                if status != "ok":
                    raise RuntimeError(f"tp rank {rank}: {value}")
                out.append(value)
            return out

    def _name(self, prefix: str) -> str:
        return f"{prefix}{next(self._names)}"

    def _model(self, name: str) -> Llama:
        model = self.state.models[name]
        model._tp_name = name
        return model

    def _named(self, name: str, cache):
        """Tag a fresh cache of rank 0 with its name. When its storage is
        collected, the followers drop theirs with the next operation (a
        deque append: a collection may run anywhere, even inside
        call())."""
        st = _storage(cache)
        st._tp_name = name
        weakref.finalize(st, self._drops.append, name)
        return cache

    @staticmethod
    def _mname(model) -> str:
        return model._tp_name

    def _step(self, op, model, cache, *args):
        """A step operation on (model, cache): rank 0 is handed the cache
        its caller holds."""
        return self.call(op, self._mname(model), _storage(cache)._tp_name,
                         *args, local={"cache": cache})

    def _mutate(self, op, cache, *args):
        return self.call(op, _storage(cache)._tp_name, *args,
                         local={"cache": cache})

    # ----- models -----

    def random_model(self, cfg: LlamaConfig, seed: int = 0) -> Llama:
        """Every rank's shard of init_params(cfg, seed), drawn on its
        own device; returns rank 0's."""
        validate_tp(cfg, self.size)
        name = self._name("m")
        self.call("model_random", name, cfg, seed)
        return self._model(name)

    def checkpoint_model(self, path: str, **cfg_fields
                         ) -> tuple[Llama, LlamaConfig]:
        """Every rank reads a checkpoint (convert.checkpoint_weights) one
        weight at a time on the host and keeps its shard on its device;
        `cfg_fields` replace fields of the checkpoint's config
        (moe_decode_ep)."""
        name = self._name("m")
        cfg = self.call("model_checkpoint", name, path, cfg_fields)
        return self._model(name), cfg

    def shard_model(self, model: Llama, cfg: LlamaConfig | None = None
                    ) -> Llama:
        """A whole model that rank 0 holds, sent to every rank as host
        tensors; each keeps its shard. For small models (the tests)."""
        cfg = cfg or model.cfg
        validate_tp(cfg, self.size)
        weights = {k: v.detach().cpu() for k, v in
                   model.state_dict().items()}
        name = self._name("m")
        self.call("model_weights", name, cfg, weights)
        return self._model(name)

    def quantize(self, model: Llama) -> Llama:
        """Every rank's int8 copy of its shard (quantize_shard)."""
        name = self._name("m")
        self.call("model_quantize", self._mname(model), name)
        return self._model(name)

    def truncate_params(self, model: Llama, n_layers: int) -> Llama:
        """spec.truncate_params on every rank (the self-draft shares the
        sharded weights)."""
        name = self._name("m")
        self.call("model_truncate", self._mname(model), name, n_layers)
        return self._model(name)

    def drop_model(self, model: Llama) -> None:
        self.call("drop", (self._mname(model),), ())

    # ----- caches -----

    def _init(self, kind: str, cfg, args):
        name = self._name("c")
        return self._named(name, self.call("cache_init", name, kind, cfg,
                                           args))

    def init_cache(self, cfg, batch, max_len, device=None):
        return self._init("contiguous", cfg, (batch, max_len))

    def init_slot_cache(self, cfg, slots, max_len, device=None):
        return self._init("slot", cfg, (slots, max_len))

    def init_paged_cache(self, cfg, slots, n_pages, page, max_pages,
                         device=None):
        return self._init("paged", cfg, (slots, n_pages, page, max_pages))

    # ----- the step functions (models.decode's, over the group) -----

    def decode_step(self, model, cache, tokens, cfg, active=None,
                    plain=False, advance=True):
        return self._step("decode_step", model, cache, _host(tokens),
                          _host(active), plain, advance)

    def decode_step_slots(self, model, cache, tokens, active, cfg,
                          plain=False):
        return self._step("decode_step_slots", model, cache, _host(tokens),
                          _host(active), plain, False)

    def decode_step_paged(self, model, cache, tokens, active, cfg,
                          plain=False):
        return self._step("decode_step_slots", model, cache, _host(tokens),
                          _host(active), plain, True)

    def verify_step(self, model, cache, tokens, active, cfg, plain=False):
        return self.decode_step(model, cache, tokens, cfg, active=active,
                                plain=plain, advance=False)

    def prefill_slot(self, model, cache, slot, tokens, true_len, cfg,
                     plain=False):
        return self._step("prefill_slot", model, cache, int(slot), None,
                          _host(tokens), int(true_len), plain)

    def prefill_slot_paged(self, model, cache, slot, rows, tokens, true_len,
                           cfg, plain=False):
        return self._step("prefill_slot", model, cache, int(slot),
                          _host(rows), _host(tokens), int(true_len), plain)

    def prefill_suffix_slot(self, model, cache, slot, suffix_tokens, start,
                            new_len, cfg, plain=False):
        return self._step("prefill_suffix", model, cache, int(slot),
                          _host(suffix_tokens), int(start), int(new_len),
                          plain)

    def prefill_suffix_paged(self, model, cache, slot, suffix_tokens,
                             true_len, cfg, plain=False):
        return self._step("prefill_suffix", model, cache, int(slot),
                          _host(suffix_tokens), None, int(true_len), plain)

    def advance_lengths(self, cache, counts, active=None):
        return self._mutate("advance_lengths", cache, _host(counts),
                            _host(active))

    def copy_lengths(self, dst, src):
        return self.call("copy_lengths", _storage(dst)._tp_name,
                         _storage(src)._tp_name,
                         local={"dst_cache": dst, "src_cache": src})

    def set_slot_pages(self, cache, slot, rows, length):
        return self._mutate("set_slot_pages", cache, int(slot), _host(rows),
                            int(length))

    def assign_pages(self, cache, page_pos, rows, mask):
        return self._mutate("assign_pages", cache, _host(page_pos),
                            _host(rows), _host(mask))

    def generate(self, model, prompt, cfg, max_new_tokens,
                 temperature: float = 0.0, generator=None, plain=False,
                 speculate: str = "off", spec_k: int = 4,
                 draft_layers: int = 2, spec_stats=None):
        """models.decode.generate over the group; rank 0 alone samples,
        with `generator`. Speculation does not run here, as in the JAX
        package: the engines' speculative ticks do."""
        if speculate != "off":
            raise NotImplementedError(
                "speculative generate() does not run tensor-parallel; "
                "the serving engines run tp speculative decoding")
        return self.call("generate", self._mname(model), _host(prompt),
                         int(max_new_tokens), float(temperature), plain,
                         local={"generator": generator})

    # ----- what the group holds -----

    def stats(self, reset_launches: bool = False,
              reset_peak: bool = False) -> list[dict]:
        """Every rank's pid, device, kernel launches and peak memory,
        each counted anew from here where asked."""
        return self.call("stats", reset_launches, reset_peak, reply=True)

    def check_kernels(self, model: Llama, qmodel: Llama, seed: int,
                      slots: int, chunk_len: int, row_floor: float
                      ) -> list[dict]:
        """_op_check_kernels on every rank, with `model` and its int8 copy
        `qmodel`: each rank's answers in rank order."""
        return self.call("check_kernels", self._mname(model),
                         self._mname(qmodel), seed, slots, chunk_len,
                         row_floor, reply=True)

    def describe(self) -> dict:
        """The group as serve's /debugz?state=1 shows it."""
        return {"tp": self.size, "backend": self.backend,
                "devices": [str(d) for d in self.devices],
                "pids": [os.getpid()] + [p.pid for p in self.procs],
                "timeout_s": self.timeout_s, "lost": self.dead}


# ---------- ranks 1..tp-1 ----------

def follower_loop(conn: Connection, tp: TPGroup) -> None:
    """Run rank 0's operations until it says exit or its socket closes.
    An operation that fails ends the process (non-zero): its collectives
    may be out of step with rank 0's, and rank 0 learns of the death."""
    st = RankState(tp)
    while True:
        try:
            op, args, reply = _recv(conn)
        except (EOFError, OSError):
            log.info("tp rank %d: rank 0 is gone", tp.rank)
            os._exit(0)
        if op == "exit":
            return
        try:
            value = OPS[op](st, *args)
        except BaseException:   # noqa: BLE001 - reported, then fatal
            traceback.print_exc()
            if reply:
                _send(conn, ("error", traceback.format_exc(limit=4)))
            sys.stderr.flush()
            os._exit(1)
        if reply:
            _send(conn, ("ok", value))
        del value


def follower_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a tensor-parallel follower "
                                "rank (started by TPRuntime)")
    p.add_argument("--follower", action="store_true", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--tp", type=int, required=True)
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--fd", type=int, required=True)
    p.add_argument("--parent", type=int, required=True)
    args = p.parse_args(argv)
    _set_pdeathsig()
    if os.getppid() != args.parent:   # rank 0 died before the signal
        return 1
    logging.basicConfig(level=logging.INFO)
    if args.threads:
        torch.set_num_threads(args.threads)
    conn = Connection(args.fd)
    device = torch.device(args.device)
    if device.type == "cuda":
        # Rank 0 built the kernels before it spawned this rank.
        from container_engine_accelerators_tpu_torch import kernels
        kernels.load()
    _send(conn, "hello")
    store = dist.TCPStore("127.0.0.1", args.store_port, args.tp,
                          is_master=False,
                          timeout=datetime.timedelta(seconds=args.timeout))
    tp = init_tp_group(args.rank, args.tp, store, args.backend, device,
                       args.timeout)
    follower_loop(conn, tp)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(follower_main())
