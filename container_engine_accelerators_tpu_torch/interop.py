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
    decode_dtype,
    layer_weights,
)
from container_engine_accelerators_tpu_torch.ops.quant import QuantWeight


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
    a Llama on `device`, each weight in its decode-path dtype (a mixture
    of experts' w_router too, and its [E, D, F] and [E, F, D] stacks)."""
    stacked = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layers.append(LlamaLayer(**{
            name: _weight(stacked[name], decode_dtype(cfg, name), device,
                          index=i)
            for name in layer_weights(cfg)}))
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
                            for name in layer_weights(cfg)})
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
                   for name in layer_weights(model.cfg)},
        "final_norm": arr(model.final_norm),
        "lm_head": arr(model.lm_head),
    }


# ---------- the vision demos ----------

def mnist_params_from_jax(tree: dict, device: str | torch.device = "cpu"
                          ) -> dict:
    """The JAX MLP's {w1, b1, w2, b2} as f32 tensors on `device` that
    require grad (models/mnist.py's layout is the JAX package's)."""
    return {k: to_torch(v).to(device).requires_grad_()
            for k, v in tree.items()}


def _resnet_leaves(cfg):
    """(JAX tree path, module name, kind) of every leaf of a ResNet:
    kind 'conv' (HWIO in the tree, OIHW in the module), 'param' or
    'stat'."""
    def conv_bn(path, name):
        return [(("params", *path, "conv"), f"{name}.conv", "conv"),
                (("params", *path, "bn", "scale"), f"{name}.bn.scale",
                 "param"),
                (("params", *path, "bn", "bias"), f"{name}.bn.bias",
                 "param"),
                (("batch_stats", *path, "mean"), f"{name}.bn.mean", "stat"),
                (("batch_stats", *path, "var"), f"{name}.bn.var", "stat")]

    out = conv_bn(("stem",), "stem")
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** si) * cfg.block_expansion
        for bi in range(n_blocks):
            base = f"stages.{si}.{bi}"
            for ci in range(3 if cfg.bottleneck else 2):
                out += conv_bn(("stages", si, bi, "convs", ci),
                               f"{base}.convs.{ci}")
            if (si > 0 and bi == 0) or cin != cout:
                out += conv_bn(("stages", si, bi, "proj"), f"{base}.proj")
            cin = cout
    out += [(("params", "fc", "w"), "fc.w", "param"),
            (("params", "fc", "b"), "fc.b", "param")]
    return out


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def resnet_variables_from_jax(variables: dict, cfg,
                              device: str | torch.device = "cpu"):
    """The JAX {'params', 'batch_stats'} tree of models/resnet.py (after
    jax.device_get) as a models.resnet.ResNet on `device`, bit for bit:
    HWIO convolutions become OIHW (channels_last), the stage lists the
    module's `stages.<s>.<b>` names."""
    from container_engine_accelerators_tpu_torch.models.resnet import ResNet

    model = ResNet(cfg, None, device)
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for path, name, kind in _resnet_leaves(cfg):
            arr = to_torch(_at(variables, path))
            if kind == "conv":
                arr = arr.permute(3, 2, 0, 1)
            named[name].copy_(arr)
    return model


def resnet_variables_to_numpy(model) -> dict:
    """A ResNet's parameters and running statistics as the JAX tree
    {'params': {stem, stages[s][b]{convs[i], proj}, fc}, 'batch_stats':
    ...} of numpy arrays, convolutions back in HWIO."""
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    tree: dict = {}
    for path, name, kind in _resnet_leaves(model.cfg):
        arr = named[name].detach().cpu().float()
        if kind == "conv":
            arr = arr.permute(2, 3, 1, 0)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
        node[path[-1]] = arr.contiguous().numpy().copy()
    return tree
