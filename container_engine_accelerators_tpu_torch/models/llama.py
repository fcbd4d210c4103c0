"""Llama-3-family model definition for the decode path: the config, its
presets and JSON form, the parameter modules and their random init.

Each weight is stored in the dtype the decode path uses it in: the
projections and the embedding in cfg.dtype (the JAX package keeps f32
masters and casts them to cfg.dtype at use, which rounds the same way),
the norm weights and the lm_head in f32 (the logits are an f32 product).
The training forward comes with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


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
    kv_cache_dtype: str = "bf16"                 # only bf16 in this slice

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

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
              n_kv_heads=2, d_ff=256, max_seq_len=256)
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
    this port decodes dense models only."""
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


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: str | torch.device) -> Llama:
    """Random weights with the JAX package's distributions (normal *
    fan_in^-0.5, embed normal * 0.02, norms one), drawn from `generator`
    on `device`. The numbers differ from jax.random's; carry JAX weights
    across with interop.params_from_jax where they must match."""
    hd, d, dt = cfg.head_dim, cfg.d_model, cfg.dtype

    def normal(shape, std, dtype):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(std).to(dtype)

    def dense(shape, dtype=dt):
        return normal(shape, shape[0] ** -0.5, dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    layers = [LlamaLayer(
        attn_norm=ones(),
        wq=dense((d, cfg.n_heads * hd)),
        wk=dense((d, cfg.n_kv_heads * hd)),
        wv=dense((d, cfg.n_kv_heads * hd)),
        wo=dense((cfg.n_heads * hd, d)),
        mlp_norm=ones(),
        w_gate=dense((d, cfg.d_ff)),
        w_up=dense((d, cfg.d_ff)),
        w_down=dense((cfg.d_ff, d)),
    ) for _ in range(cfg.n_layers)]
    return Llama(cfg, embed=normal((cfg.vocab_size, d), 0.02, dt),
                 layers=layers, final_norm=ones(),
                 lm_head=dense((d, cfg.vocab_size), torch.float32))
