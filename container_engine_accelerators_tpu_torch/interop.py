"""Carry a JAX-package parameter tree across to the port's modules.

`params_from_jax` takes the tree after `jax.device_get`: numpy arrays,
with the layer weights stacked on a leading [n_layers] axis and, for a
quantized tree, `(values, scales)` QuantWeight tuples. It needs no JAX
import: bf16 arrays are moved bit for bit by viewing them as uint16.
"""

from __future__ import annotations

import numpy as np
import torch

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
