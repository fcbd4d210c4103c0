"""Llama-3-family model: the config, its presets and JSON form, the
parameter modules, their random init, and the training forward.

For decoding (`init_params`, models/decode.py), each weight is stored
frozen in the dtype the decode path uses it in: the projections and the
embedding in cfg.dtype (the JAX package keeps f32 masters and casts them
to cfg.dtype at use, which rounds the same way), the norm weights and the
lm_head in f32. For training (`init_train_params`, `forward`), every
weight is a trainable master in cfg.param_dtype, cast to cfg.dtype where
it is used, as in the JAX package.

Across ranks (`forward(..., mesh=)`, training/train.py) each rank holds
its fsdp shards of the f32 masters (parallel/sharding.py): a layer's
weights reach it through GatherShard inside the region its remat policy
recomputes, the embedding and the lm_head once a step; with sp > 1
(cfg.sequence_parallel) the rank holds one chunk of the sequence, RoPE
takes the chunk's global positions, and the attention core is ring or
Ulysses attention (parallel/ring_attention.py, parallel/ulysses.py).

A config with n_experts > 0 is a mixture-of-experts model
(models/moe.py): each layer's FFN is a router w_router [D, E] and
expert stacks w_gate, w_up [E, D, F] and w_down [E, F, D]. At decode
the router is kept in f32, as the JAX package's serving params keep it.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from container_engine_accelerators_tpu_torch.models import moe
from container_engine_accelerators_tpu_torch.ops import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from container_engine_accelerators_tpu_torch.ops.attention import (
    multi_head_attention,
)
from container_engine_accelerators_tpu_torch.parallel import sharding
from container_engine_accelerators_tpu_torch.parallel.mesh import TOKEN_AXES


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16          # activations
    param_dtype: torch.dtype = torch.float32     # training master weights
    # Training: 'none' | 'dots' | 'dots_all' | 'full' | 'dots_save_attn'
    # (see forward).
    remat_policy: str = "dots"
    use_flash: bool | None = None                # None: flash on CUDA
    flash_causal_grid: str = "rect"              # 'rect' | 'tri'
    # Serving KV cache: 'bf16' (cfg.dtype), 'int8' or 'int4' (int8 storage
    # at head_dim / 2, two nibbles a byte), with per-(token, head) scales.
    kv_cache_dtype: str = "bf16"
    # Mixture-of-experts FFN (models/moe.py); 0 experts is the dense MLP.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # 'token_choice' (tokens pick their top-k experts, capacity-dropped)
    # or 'expert_choice' (experts pick their top-C tokens; non-causal).
    moe_router: str = "token_choice"
    # Token choice with no capacity: every routed token is computed.
    moe_dropless: bool = False
    # Expert parallelism's dispatch (ep > 1, ROADMAP item 12); carried
    # so that a JAX config record round-trips.
    moe_ep_buffer_factor: float = 2.0
    moe_ep_dispatch: str = "bucket"
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 0.001
    # Experts sharded over tensor parallelism at decode (ROADMAP item 8).
    moe_decode_ep: bool = False
    # Sequence parallelism over the mesh's 'sp' axis in training: 'ring'
    # rotates KV chunks around the sp ranks, 'ulysses' trades the
    # sequence for heads with one all-to-all each way (needs n_heads and
    # n_kv_heads divisible by sp).
    sequence_parallel: bool = False
    sequence_parallel_mode: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def train_flops_per_token(self, seq_len: int) -> float:
        """Training (forward + backward) FLOPs per token: 6 per matmul
        parameter (the lm_head counted, the embedding gather not) plus
        the causal attention term 6 * L * d_model * S. A mixture of
        experts counts one FFN a token, not top_k, as the JAX package
        does."""
        hd = self.head_dim
        attn = self.n_layers * self.d_model * hd * (
            2 * self.n_heads + 2 * self.n_kv_heads)
        mlp = self.n_layers * 3 * self.d_model * self.d_ff
        matmul_params = attn + mlp + self.vocab_size * self.d_model
        return (6.0 * matmul_params
                + 6.0 * self.n_layers * self.d_model * seq_len)

    def num_params(self) -> int:
        hd = self.head_dim
        mlp = 3 * self.d_model * self.d_ff
        if self.n_experts:
            mlp = (self.n_experts * mlp                         # experts
                   + self.d_model * self.n_experts)             # router
        per_layer = (2 * self.d_model                          # norms
                     + self.d_model * hd * self.n_heads         # wq
                     + 2 * self.d_model * hd * self.n_kv_heads  # wk, wv
                     + hd * self.n_heads * self.d_model         # wo
                     + mlp)
        return (self.vocab_size * self.d_model * 2              # embed, head
                + self.n_layers * per_layer + self.d_model)


def llama3_8b(**overrides) -> LlamaConfig:
    return LlamaConfig(**overrides)


def llama3_1b(**overrides) -> LlamaConfig:
    kw = dict(vocab_size=128256, d_model=2048, n_layers=16, n_heads=32,
              n_kv_heads=8, d_ff=8192)
    kw.update(overrides)
    return LlamaConfig(**kw)


def llama_tiny(**overrides) -> LlamaConfig:
    kw = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=256, max_seq_len=256, remat_policy="none")
    kw.update(overrides)
    return LlamaConfig(**kw)


_DTYPE_KEYS = ("dtype", "param_dtype")

def cfg_to_json_dict(cfg: LlamaConfig) -> dict:
    """LlamaConfig -> JSON-serializable dict; dtypes become their numpy
    names ("bfloat16", "float32"), as in the JAX package's form."""
    d = dataclasses.asdict(cfg)
    for key in _DTYPE_KEYS:
        d[key] = str(d[key]).removeprefix("torch.")
    return d


def cfg_from_json_dict(d: dict) -> LlamaConfig:
    """Inverse of cfg_to_json_dict; also reads the JAX package's form.
    Unknown keys are dropped."""
    d = dict(d)
    for key in _DTYPE_KEYS:
        if isinstance(d.get(key), str):
            d[key] = getattr(torch, d[key])
    known = {f.name for f in dataclasses.fields(LlamaConfig)}
    return LlamaConfig(**{k: v for k, v in d.items() if k in known})


def _as_param(w):
    """Tensors become frozen Parameters; Parameters and QuantWeight
    modules are kept as they are (shared, not copied)."""
    if isinstance(w, (nn.Module, nn.Parameter)):
        return w
    return nn.Parameter(w, requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's weights, each [in, out] (x @ w): those it is
    given, in WEIGHTS' order (layer_weights(cfg) names a config's). A
    mixture-of-experts layer's FFN weights are stacks with a leading [E]
    axis."""

    WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_router",
               "w_gate", "w_up", "w_down")

    def __init__(self, **weights):
        super().__init__()
        for name in self.WEIGHTS:
            if name in weights:
                setattr(self, name, _as_param(weights[name]))


def layer_weights(cfg: LlamaConfig) -> tuple[str, ...]:
    """The names of a layer's weights under cfg: LlamaLayer.WEIGHTS, less
    w_router for a dense model."""
    if cfg.n_experts:
        return LlamaLayer.WEIGHTS
    return tuple(n for n in LlamaLayer.WEIGHTS if n != "w_router")


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, embed, layers, final_norm,
                 lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = _as_param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = _as_param(final_norm)
        self.lm_head = _as_param(lm_head)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def _random_llama(cfg: LlamaConfig, generator: torch.Generator, device,
                  dtype_of, trainable: bool, keep=None) -> Llama:
    """Random weights with the JAX package's distributions (normal *
    fan_in^-0.5, embed normal * 0.02, norms one), drawn in f32 from
    `generator` on `device`, each cast to dtype_of(its name). `keep(name,
    w)`, when given, returns the part of each drawn f32 weight to keep
    (a tensor-parallel rank's shard, models/decode_tp.py); the draws, and
    so the kept values, are those of the whole model."""
    hd, d = cfg.head_dim, cfg.d_model

    def param(name, w):
        if keep is not None:
            w = keep(name, w)
        return nn.Parameter(w.to(dtype_of(name)), requires_grad=trainable)

    def normal(name, shape, std):
        return param(name, torch.randn(shape, generator=generator,
                                       device=device,
                                       dtype=torch.float32).mul_(std))

    def dense(name, shape, fan_in=None):
        return normal(name, shape, (fan_in or shape[0]) ** -0.5)

    def ones(name):
        return param(name, torch.ones(d, dtype=torch.float32, device=device))

    def ffn():
        if not cfg.n_experts:
            return dict(w_gate=dense("w_gate", (d, cfg.d_ff)),
                        w_up=dense("w_up", (d, cfg.d_ff)),
                        w_down=dense("w_down", (cfg.d_ff, d)))
        # Each expert stack is drawn in f32 and cast before the next is
        # drawn: one f32 stack is 1.88 GB at Mixtral-8x7B's widths.
        e = cfg.n_experts
        return dict(w_router=dense("w_router", (d, e)),
                    w_gate=dense("w_gate", (e, d, cfg.d_ff), d),
                    w_up=dense("w_up", (e, d, cfg.d_ff), d),
                    w_down=dense("w_down", (e, cfg.d_ff, d), cfg.d_ff))

    layers = [LlamaLayer(
        attn_norm=ones("attn_norm"),
        wq=dense("wq", (d, cfg.n_heads * hd)),
        wk=dense("wk", (d, cfg.n_kv_heads * hd)),
        wv=dense("wv", (d, cfg.n_kv_heads * hd)),
        wo=dense("wo", (cfg.n_heads * hd, d)),
        mlp_norm=ones("mlp_norm"),
        **ffn(),
    ) for _ in range(cfg.n_layers)]
    return Llama(cfg, embed=normal("embed", (cfg.vocab_size, d), 0.02),
                 layers=layers, final_norm=ones("final_norm"),
                 lm_head=dense("lm_head", (d, cfg.vocab_size)))


_F32_WEIGHTS = ("attn_norm", "mlp_norm", "final_norm", "lm_head",
                "w_router")


def decode_dtype(cfg: LlamaConfig, name: str) -> torch.dtype:
    """The decode path's dtype of weight `name`: f32 for the norms, the
    lm_head and the router, cfg.dtype for the rest."""
    return torch.float32 if name in _F32_WEIGHTS else cfg.dtype


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device) -> Llama:
    """Frozen random weights for decoding, each in its decode-path dtype
    (norms and lm_head f32, the rest cfg.dtype). The numbers differ from
    jax.random's; carry JAX weights across with interop.params_from_jax
    where they must match."""
    return _random_llama(cfg, generator, device,
                         functools.partial(decode_dtype, cfg),
                         trainable=False)


def init_train_params(cfg: LlamaConfig, generator: torch.Generator,
                      device: str | torch.device, keep=None) -> Llama:
    """Trainable master weights in cfg.param_dtype, drawn as init_params
    draws them; every weight requires grad. `keep(name, w)` keeps a part
    of each drawn weight (a rank's shard: training/train.py), as
    _random_llama does. Carry JAX weights across with
    interop.train_params_from_jax where they must match."""
    return _random_llama(cfg, generator, device,
                         lambda name: cfg.param_dtype, trainable=True,
                         keep=keep)


class _MatmulF32Out(torch.autograd.Function):
    """x @ w for low-precision x [T, D] and w [D, V], with an f32 result
    (the JAX package's bf16 x bf16 product with f32 output). On the card
    the product is one bf16 GEMM writing f32 (`torch.mm(out_dtype=)`);
    its backward rounds the f32 cotangent to the operands' dtype and runs
    two bf16 GEMMs, where an f32 GEMM at vocabulary width would take
    seconds. On the CPU both operands are upcast: the products of bf16
    values are exact in f32, and the backward is f32 too, as on JAX's
    CPU backend."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cuda":
            g = g.to(x.dtype)
            return g @ w.t(), x.t() @ g
        return ((g @ w.float().t()).to(x.dtype),
                (x.float().t() @ g).to(w.dtype))


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x @ w
    return _MatmulF32Out.apply(x, w)


# Remat policies: the aten ops whose outputs a layer's checkpoint keeps
# (the rest is recomputed in the backward). 'dots' keeps the matmuls
# without batch dims, 'dots_all' also the batched ones; the layer's
# matmuls are all unbatched, so on the flash path the two keep the same
# set. 'full' keeps nothing but the layer's input.
_SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_all": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default),
}
# Not a set of saved ops but a split of the layer: two 'dots'-rematted
# halves with the attention core between them, outside any checkpoint.
# The flash Function then keeps q, k, v, out and lse for its backward
# (~168 MB a layer at B 4 x S 2048, 32/8 heads of 128, bf16), and the
# backward replays no K4: one forward launch a layer a step, not two.
REMAT_SPLIT_ATTN = "dots_save_attn"
REMAT_POLICIES = ("none", "dots", "dots_all", "full", REMAT_SPLIT_ATTN)


KV_CACHE_DTYPES = ("bf16", "int8", "int4")


def check_kv_cache_dtype(cfg: LlamaConfig) -> None:
    """The JAX package's validation of cfg.kv_cache_dtype."""
    if cfg.kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be 'bf16', 'int8' or 'int4', "
                         f"got {cfg.kv_cache_dtype!r}")
    if cfg.kv_cache_dtype == "int4" and cfg.head_dim % 2:
        raise ValueError(
            f"kv_cache_dtype='int4' packs two nibbles per byte over "
            f"head_dim; head_dim={cfg.head_dim} must be even")


def _check_train_config(cfg: LlamaConfig) -> None:
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"valid: {REMAT_POLICIES}")
    if cfg.n_experts and cfg.moe_dropless \
            and cfg.moe_router != "token_choice":
        raise ValueError(
            "moe_dropless implements token-choice routing; it cannot "
            "combine with moe_router='expert_choice' (which is already "
            "dropless - drop the moe_dropless flag)")
    if cfg.flash_causal_grid not in ("rect", "tri"):
        raise ValueError(f"flash_causal_grid must be 'rect' or 'tri', got "
                         f"{cfg.flash_causal_grid!r}")
    check_kv_cache_dtype(cfg)
    if (cfg.flash_causal_grid == "tri" and cfg.sequence_parallel
            and cfg.sequence_parallel_mode == "ring"):
        # Ring attention never reaches the flash causal grid: a 'tri'
        # config would be measured as something it is not.
        raise ValueError(
            "flash_causal_grid='tri' has no effect under "
            "sequence_parallel_mode='ring'; use 'rect' (ring schedules "
            "its own KV rotation) or ulysses sequence parallelism")


class _LayerView:
    """A layer's weights as the layer uses them. Without a mesh, the
    layer's own parameters (the layer casts them); on a mesh, each
    weight the first time it is read: gathered over fsdp in cfg.dtype
    (parallel/sharding.gather_param), the norms as they are and the
    router in f32."""

    def __init__(self, layer: LlamaLayer, cfg: LlamaConfig, mesh):
        self._layer, self._cfg, self._mesh = layer, cfg, mesh

    def __getattr__(self, name: str):
        w = getattr(self._layer, name)
        if self._mesh is None:
            return w
        dtype = (w.dtype if name in ("attn_norm", "mlp_norm")
                 else torch.float32 if name == "w_router"
                 else self._cfg.dtype)
        out = sharding.gather_param(
            w, sharding.param_spec(f"layers.0.{name}",
                                   bool(self._cfg.n_experts)),
            self._mesh, dtype)
        setattr(self, name, out)
        return out


def _attention_qkv(x: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig,
                   cos: torch.Tensor, sin: torch.Tensor, mesh=None):
    b, s, _ = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    lp = _LayerView(layer, cfg, mesh)
    h = rms_norm(x, lp.attn_norm, cfg.norm_eps)
    q = (h @ lp.wq.to(dt)).view(b, s, cfg.n_heads, hd)
    k = (h @ lp.wk.to(dt)).view(b, s, cfg.n_kv_heads, hd)
    v = (h @ lp.wv.to(dt)).view(b, s, cfg.n_kv_heads, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attention_core(q, k, v, cfg: LlamaConfig, plain: bool,
                    mesh=None) -> torch.Tensor:
    """Flash (or the reference) on one rank's whole sequence, or ring or
    Ulysses attention over the sp ranks' chunks, as the JAX package
    dispatches."""
    if cfg.sequence_parallel:
        if mesh is None:
            from container_engine_accelerators_tpu_torch.parallel.mesh import (  # noqa: E501
                single_mesh,
            )
            mesh = single_mesh(q.device)
        if cfg.sequence_parallel_mode == "ulysses":
            from container_engine_accelerators_tpu_torch.parallel import (
                ulysses,
            )
            return ulysses.ulysses_attention(
                q, k, v, mesh, causal=True, use_flash=cfg.use_flash,
                causal_grid=cfg.flash_causal_grid, plain=plain)
        if cfg.sequence_parallel_mode == "ring":
            from container_engine_accelerators_tpu_torch.parallel import (
                ring_attention,
            )
            return ring_attention.ring_attention(q, k, v, mesh, causal=True)
        raise ValueError(
            f"unknown sequence_parallel_mode "
            f"{cfg.sequence_parallel_mode!r}; valid: ring, ulysses")
    return multi_head_attention(q, k, v, causal=True,
                                use_flash=cfg.use_flash,
                                causal_grid=cfg.flash_causal_grid,
                                plain=plain)


def _attention_out_mlp(x: torch.Tensor, attn: torch.Tensor,
                       layer: LlamaLayer, cfg: LlamaConfig, mesh=None,
                       share=None):
    """wo, the residual and the FFN: (x, the router's aux loss). The aux
    is moe_aux_weight * aux_loss + moe_z_weight * router_z_loss for a
    mixture of experts (with a `share`, this rank's share of them:
    models/moe.py), None for a dense layer."""
    b, s, _ = x.shape
    dt = cfg.dtype
    lp = _LayerView(layer, cfg, mesh)
    x = x + attn.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp.wo.to(dt)
    h = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if cfg.n_experts:
        if cfg.moe_dropless:
            out, metrics = moe.moe_mlp_dropless(h, lp, cfg, share=share)
        else:
            out, metrics = moe.moe_mlp(h, lp, cfg, share=share)
        return x + out, (cfg.moe_aux_weight * metrics.aux_loss
                         + cfg.moe_z_weight * metrics.router_z_loss)
    gate = F.silu(h @ lp.w_gate.to(dt))
    up = h @ lp.w_up.to(dt)
    return x + (gate * up) @ lp.w_down.to(dt), None


def _layer(x: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor, plain: bool, mesh=None,
           share=None):
    q, k, v = _attention_qkv(x, layer, cfg, cos, sin, mesh)
    return _attention_out_mlp(x, _attention_core(q, k, v, cfg, plain, mesh),
                              layer, cfg, mesh, share)


def _saved_ops_context(policy: str):
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             list(_SAVED_OPS[policy]))


def _split_attn_layer(x: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig,
                      cos: torch.Tensor, sin: torch.Tensor, plain: bool,
                      mesh=None, share=None):
    """'dots_save_attn': the pre half (norm, q/k/v, RoPE) and the post
    half (wo, residual, MLP) each under the 'dots' checkpoint, the
    attention core between them outside both."""
    q, k, v = ckpt.checkpoint(_attention_qkv, x, layer, cfg, cos, sin, mesh,
                              use_reentrant=False,
                              context_fn=_saved_ops_context("dots"))
    attn = _attention_core(q, k, v, cfg, plain, mesh)
    return ckpt.checkpoint(_attention_out_mlp, x, attn, layer, cfg, mesh,
                           share, use_reentrant=False,
                           context_fn=_saved_ops_context("dots"))


def _warn_if_flash_off(cfg: LlamaConfig, device: torch.device) -> None:
    """The JAX package's warning: without the flash kernel, the hoisted
    attention keeps its [B, H, S, S] probabilities for the backward."""
    use_flash = (device.type == "cuda" if cfg.use_flash is None
                 else cfg.use_flash)
    if cfg.head_dim % 128 or not use_flash:
        warnings.warn(
            "remat_policy='dots_save_attn' without the flash kernel "
            "(use_flash resolves False or head_dim % 128 != 0) pins "
            "O(B*H*S^2) attention probabilities per layer - use 'dots' "
            "instead", stacklevel=3)


def forward(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
            plain: bool = False, return_aux: bool = False, mesh=None,
            loss_axes: tuple = TOKEN_AXES):
    """tokens [B, S] -> logits [B, S, vocab] f32: the JAX package's
    forward on one device. With `return_aux`, (logits, aux): the
    routers' aux losses summed over layers (an f32 scalar, zero for a
    dense model), which training adds to the loss.

    The embedding gathers from the table cast to cfg.dtype; each layer
    runs under cfg.remat_policy through torch.utils.checkpoint ('full'),
    or its selective form keeping the matmul outputs ('dots',
    'dots_all'), or as two 'dots' halves around an attention core that
    keeps its own residuals ('dots_save_attn'); the lm_head multiplies
    cfg.dtype operands into f32 logits. Attention dispatches as
    `multi_head_attention` does; `plain=True` runs flash attention's
    plain versions on the card.

    On a `mesh` (parallel/mesh.py) `model` holds this rank's shards and
    `tokens` its block of the batch [B/(dp*fsdp), S/sp]: weights are
    gathered as the module docstring says, and the logits are the
    block's. A mixture of experts' aux is then this rank's share of the
    mean over the ranks of `loss_axes` (the step's tokens, or one dp
    slice's), so the shares sum to the JAX package's aux."""
    _check_train_config(cfg)
    b, s = tokens.shape
    share = None
    if mesh is not None and mesh.axis_size(*loss_axes) > 1:
        share = (mesh.group(*loss_axes), mesh.axis_size(*loss_axes))
    offset = 0 if mesh is None else mesh.coord["sp"] * s
    cos, sin = rope_frequencies(cfg.head_dim, offset + s, cfg.rope_theta,
                                device=tokens.device)
    cos, sin = cos[offset:], sin[offset:]
    x = F.embedding(tokens, sharding.gather_param(
        model.embed, sharding.param_spec("embed"), mesh, cfg.dtype))
    if cfg.remat_policy == REMAT_SPLIT_ATTN:
        _warn_if_flash_off(cfg, tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in model.layers:
        if cfg.remat_policy == "none":
            x, aux = _layer(x, layer, cfg, cos, sin, plain, mesh, share)
        elif cfg.remat_policy == REMAT_SPLIT_ATTN:
            x, aux = _split_attn_layer(x, layer, cfg, cos, sin, plain, mesh,
                                       share)
        else:
            context_fn = ckpt.noop_context_fn
            if cfg.remat_policy in _SAVED_OPS:
                context_fn = _saved_ops_context(cfg.remat_policy)
            x, aux = ckpt.checkpoint(_layer, x, layer, cfg, cos, sin, plain,
                                     mesh, share, use_reentrant=False,
                                     context_fn=context_fn)
        if aux is not None:
            aux_total = aux_total + aux
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _logits(x.to(cfg.dtype).reshape(b * s, cfg.d_model),
                     sharding.gather_param(model.lm_head,
                                           sharding.param_spec("lm_head"),
                                           mesh, cfg.dtype))
    logits = logits.view(b, s, cfg.vocab_size)
    return (logits, aux_total) if return_aux else logits
