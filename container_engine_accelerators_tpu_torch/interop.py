"""Carry a JAX-package parameter tree across to the port's modules, and
back.

`params_from_jax` and `train_params_from_jax` take the tree after
`jax.device_get`: numpy arrays, with the layer weights stacked on a
leading [n_layers] axis and, for a quantized tree, `(values, scales)`
QuantWeight tuples. They need no JAX import: bf16 arrays are moved bit
for bit by viewing them as uint16. `params_to_numpy` gives a model's
weights back in the tree's form.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
)
from container_engine_accelerators_tpu_torch.ops.quant import QuantWeight

_NORMS = ("attn_norm", "mlp_norm")


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor of the same dtype and bits (bf16 included)."""
    arr = np.array(arr, copy=True, order="C")   # owned and writable
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_quant(leaf) -> bool:
    return isinstance(leaf, tuple) and getattr(leaf, "_fields", None) == (
        "values", "scales")


def _weight(leaf, dtype: torch.dtype, device, index=None):
    """One leaf (or its layer `index`) as a tensor in `dtype`, or as a
    QuantWeight when the leaf is one."""
    if _is_quant(leaf):
        values, scales = leaf
        if index is not None:
            values, scales = values[index], scales[index]
        return QuantWeight(to_torch(values).to(device),
                           to_torch(scales).to(device, torch.float32))
    arr = leaf if index is None else leaf[index]
    return to_torch(arr).to(device=device, dtype=dtype)


def params_from_jax(tree: dict, cfg: LlamaConfig,
                    device: str | torch.device = "cpu") -> Llama:
    """The JAX tree {embed, layers{...}[L, ...], final_norm, lm_head} as
    a Llama on `device`, each weight in its decode-path dtype."""
    stacked = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layers.append(LlamaLayer(**{
            name: _weight(stacked[name],
                          torch.float32 if name in _NORMS else cfg.dtype,
                          device, index=i)
            for name in LlamaLayer.WEIGHTS}))
    return Llama(cfg,
                 embed=_weight(tree["embed"], cfg.dtype, device),
                 layers=layers,
                 final_norm=_weight(tree["final_norm"], torch.float32,
                                    device),
                 lm_head=_weight(tree["lm_head"], torch.float32, device))


def train_params_from_jax(tree: dict, cfg: LlamaConfig,
                          device: str | torch.device = "cpu") -> Llama:
    """The JAX training tree (masters in cfg.param_dtype) as a trainable
    Llama on `device`, bit for bit: every weight a Parameter in its
    tree dtype that requires grad."""
    def param(arr):
        return nn.Parameter(to_torch(arr).to(device))

    stacked = tree["layers"]
    layers = [LlamaLayer(**{name: param(stacked[name][i])
                            for name in LlamaLayer.WEIGHTS})
              for i in range(cfg.n_layers)]
    return Llama(cfg, embed=param(tree["embed"]), layers=layers,
                 final_norm=param(tree["final_norm"]),
                 lm_head=param(tree["lm_head"]))


def params_to_numpy(model: Llama) -> dict:
    """A model's weights as the JAX tree {embed, layers{name: [L, ...]},
    final_norm, lm_head} of numpy arrays; bf16 weights come back as
    float32, which holds them exactly."""
    def arr(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy().copy()

    return {
        "embed": arr(model.embed),
        "layers": {name: np.stack([arr(getattr(layer, name))
                                   for layer in model.layers])
                   for name in LlamaLayer.WEIGHTS},
        "final_norm": arr(model.final_norm),
        "lm_head": arr(model.lm_head),
    }
