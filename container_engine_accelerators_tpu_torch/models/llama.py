"""Llama-3-family model: the config, its presets and JSON form, the
parameter modules, their random init, and the training forward.

For decoding (`init_params`, models/decode.py), each weight is stored
frozen in the dtype the decode path uses it in: the projections and the
embedding in cfg.dtype (the JAX package keeps f32 masters and casts them
to cfg.dtype at use, which rounds the same way), the norm weights and the
lm_head in f32. For training (`init_train_params`, `forward`), every
weight is a trainable master in cfg.param_dtype, cast to cfg.dtype where
it is used, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from container_engine_accelerators_tpu_torch.ops import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from container_engine_accelerators_tpu_torch.ops.attention import (
    multi_head_attention,
)


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
    # Training: 'none' | 'dots' | 'dots_all' | 'full' (see forward);
    # 'dots_save_attn' is not ported yet.
    remat_policy: str = "dots"
    use_flash: bool | None = None                # None: flash on CUDA
    flash_causal_grid: str = "rect"              # 'rect' | 'tri'
    # Serving KV cache: 'bf16' (cfg.dtype), 'int8' or 'int4' (int8 storage
    # at head_dim / 2, two nibbles a byte), with per-(token, head) scales.
    kv_cache_dtype: str = "bf16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def train_flops_per_token(self, seq_len: int) -> float:
        """Training (forward + backward) FLOPs per token: 6 per matmul
        parameter (the lm_head counted, the embedding gather not) plus
        the causal attention term 6 * L * d_model * S."""
        hd = self.head_dim
        attn = self.n_layers * self.d_model * hd * (
            2 * self.n_heads + 2 * self.n_kv_heads)
        mlp = self.n_layers * 3 * self.d_model * self.d_ff
        matmul_params = attn + mlp + self.vocab_size * self.d_model
        return (6.0 * matmul_params
                + 6.0 * self.n_layers * self.d_model * seq_len)

    def num_params(self) -> int:
        hd = self.head_dim
        per_layer = (2 * self.d_model                          # norms
                     + self.d_model * hd * self.n_heads         # wq
                     + 2 * self.d_model * hd * self.n_kv_heads  # wk, wv
                     + hd * self.n_heads * self.d_model         # wo
                     + 3 * self.d_model * self.d_ff)            # mlp
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
    Unknown keys are dropped, but a mixture-of-experts config raises:
    this port runs dense models only."""
    if d.get("n_experts"):
        raise NotImplementedError("MoE configs are not ported yet")
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
    """One decoder layer's weights, each [in, out] (x @ w)."""

    WEIGHTS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")

    def __init__(self, **weights):
        super().__init__()
        for name in self.WEIGHTS:
            setattr(self, name, _as_param(weights[name]))


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
                  dtype_of, trainable: bool) -> Llama:
    """Random weights with the JAX package's distributions (normal *
    fan_in^-0.5, embed normal * 0.02, norms one), drawn in f32 from
    `generator` on `device`, each cast to dtype_of(its name)."""
    hd, d = cfg.head_dim, cfg.d_model

    def param(name, w):
        return nn.Parameter(w.to(dtype_of(name)), requires_grad=trainable)

    def normal(name, shape, std):
        return param(name, torch.randn(shape, generator=generator,
                                       device=device,
                                       dtype=torch.float32).mul_(std))

    def dense(name, shape):
        return normal(name, shape, shape[0] ** -0.5)

    def ones(name):
        return param(name, torch.ones(d, dtype=torch.float32, device=device))

    layers = [LlamaLayer(
        attn_norm=ones("attn_norm"),
        wq=dense("wq", (d, cfg.n_heads * hd)),
        wk=dense("wk", (d, cfg.n_kv_heads * hd)),
        wv=dense("wv", (d, cfg.n_kv_heads * hd)),
        wo=dense("wo", (cfg.n_heads * hd, d)),
        mlp_norm=ones("mlp_norm"),
        w_gate=dense("w_gate", (d, cfg.d_ff)),
        w_up=dense("w_up", (d, cfg.d_ff)),
        w_down=dense("w_down", (cfg.d_ff, d)),
    ) for _ in range(cfg.n_layers)]
    return Llama(cfg, embed=normal("embed", (cfg.vocab_size, d), 0.02),
                 layers=layers, final_norm=ones("final_norm"),
                 lm_head=dense("lm_head", (d, cfg.vocab_size)))


_F32_WEIGHTS = ("attn_norm", "mlp_norm", "final_norm", "lm_head")


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device) -> Llama:
    """Frozen random weights for decoding, each in its decode-path dtype
    (norms and lm_head f32, the rest cfg.dtype). The numbers differ from
    jax.random's; carry JAX weights across with interop.params_from_jax
    where they must match."""
    return _random_llama(
        cfg, generator, device,
        lambda name: torch.float32 if name in _F32_WEIGHTS else cfg.dtype,
        trainable=False)


def init_train_params(cfg: LlamaConfig, generator: torch.Generator,
                      device: str | torch.device) -> Llama:
    """Trainable master weights in cfg.param_dtype, drawn as init_params
    draws them; every weight requires grad. Carry JAX weights across
    with interop.train_params_from_jax where they must match."""
    return _random_llama(cfg, generator, device,
                         lambda name: cfg.param_dtype, trainable=True)


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
REMAT_POLICIES = ("none", "dots", "dots_all", "full")


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
    if cfg.remat_policy == "dots_save_attn":
        raise NotImplementedError(
            "remat_policy='dots_save_attn' is not ported yet")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"valid: {REMAT_POLICIES}")
    if cfg.flash_causal_grid not in ("rect", "tri"):
        raise ValueError(f"flash_causal_grid must be 'rect' or 'tri', got "
                         f"{cfg.flash_causal_grid!r}")
    check_kv_cache_dtype(cfg)


def _layer(x: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor, plain: bool) -> torch.Tensor:
    b, s, _ = x.shape
    hd, dt = cfg.head_dim, cfg.dtype
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    q = (h @ layer.wq.to(dt)).view(b, s, cfg.n_heads, hd)
    k = (h @ layer.wk.to(dt)).view(b, s, cfg.n_kv_heads, hd)
    v = (h @ layer.wv.to(dt)).view(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = multi_head_attention(q, k, v, causal=True,
                                use_flash=cfg.use_flash,
                                causal_grid=cfg.flash_causal_grid,
                                plain=plain)
    x = x + attn.reshape(b, s, cfg.n_heads * hd) @ layer.wo.to(dt)
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
    gate = F.silu(h @ layer.w_gate.to(dt))
    up = h @ layer.w_up.to(dt)
    return x + (gate * up) @ layer.w_down.to(dt)


def forward(model: Llama, tokens: torch.Tensor, cfg: LlamaConfig,
            plain: bool = False) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] f32: the JAX package's
    forward for a dense model on one device.

    The embedding gathers from the table cast to cfg.dtype; each layer
    runs under cfg.remat_policy through torch.utils.checkpoint ('full'),
    or its selective form keeping the matmul outputs ('dots',
    'dots_all'); the lm_head multiplies cfg.dtype operands into f32
    logits. Attention dispatches as `multi_head_attention` does;
    `plain=True` runs flash attention's plain versions on the card."""
    _check_train_config(cfg)
    b, s = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim, s, cfg.rope_theta,
                                device=tokens.device)
    x = F.embedding(tokens, model.embed.to(cfg.dtype))
    for layer in model.layers:
        if cfg.remat_policy == "none":
            x = _layer(x, layer, cfg, cos, sin, plain)
            continue
        context_fn = ckpt.noop_context_fn
        if cfg.remat_policy in _SAVED_OPS:
            context_fn = functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                list(_SAVED_OPS[cfg.remat_policy]))
        x = ckpt.checkpoint(_layer, x, layer, cfg, cos, sin, plain,
                            use_reentrant=False, context_fn=context_fn)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _logits(x.to(cfg.dtype).reshape(b * s, cfg.d_model),
                     model.lm_head.to(cfg.dtype))
    return logits.view(b, s, cfg.vocab_size)
