"""Model loading shared by the CLIs, and the HuggingFace Llama format.

`load_model` routes as the JAX package's does: a directory of numeric
step dirs holding `state/` is a training checkpoint
(training/checkpoint.load_serving_params); another directory is an HF
export (`load_hf_checkpoint`); no checkpoint gives a random
`llama_tiny`. The model comes back frozen on the device, each weight in
its decode-path dtype (models/llama.py).

The HF route reads `config.json` and the weights without `transformers`:
`*.safetensors` files through utils/safetensors.py (parsed by hand), a
sharded export through `model.safetensors.index.json`, and
`pytorch_model.bin` through `torch.load(weights_only=True)`. Names map
as the JAX package's `params_from_hf` maps them: HF Linear weights are
[out, in] and this package multiplies x @ W, so every projection
transposes; HF's rotary embedding is the rotate-half convention of
ops/rope.py, so Q and K need no permutation; a checkpoint without
`lm_head.weight` ties it to the embedding. `save_hf_checkpoint` writes
`config.json` and `model.safetensors` the same way.
"""

from __future__ import annotations

import json
import os

import torch

from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaLayer,
    decode_dtype,
    init_params,
    layer_weights,
    llama_tiny,
)
from container_engine_accelerators_tpu_torch.utils import safetensors


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device to run on. Asking for CUDA where there is none
    raises: the port never drops to the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


# ---------- HF config ----------

def config_from_hf(hf: dict) -> LlamaConfig:
    """A LlamaConfig from an HF Llama `config.json` (as a dict), with
    transformers' defaults for the keys a file may leave out."""
    n_heads = int(hf["num_attention_heads"])
    d_model = int(hf["hidden_size"])
    if hf.get("head_dim") not in (None, d_model // n_heads):
        raise ValueError(f"head_dim {hf['head_dim']} != hidden_size / "
                         f"num_attention_heads ({d_model // n_heads})")
    return LlamaConfig(
        vocab_size=int(hf["vocab_size"]),
        d_model=d_model,
        n_layers=int(hf["num_hidden_layers"]),
        n_heads=n_heads,
        n_kv_heads=int(hf.get("num_key_value_heads") or n_heads),
        d_ff=int(hf["intermediate_size"]),
        max_seq_len=int(hf.get("max_position_embeddings", 2048)),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
    )


def config_to_hf(cfg: LlamaConfig) -> dict:
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "hidden_act": "silu", "attention_bias": False, "mlp_bias": False,
        "tie_word_embeddings": False, "torch_dtype": "float32",
    }


def _read_weight_file(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return safetensors.read(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def read_hf_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The HF state dict of an export directory: one `model.safetensors`
    or `pytorch_model.bin`, or the shards `model.safetensors.index.json`
    names."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        sd = {}
        for name in files:
            sd.update(safetensors.read(os.path.join(path, name)))
        return sd
    for name in ("model.safetensors", "pytorch_model.bin"):
        if os.path.exists(os.path.join(path, name)):
            return _read_weight_file(os.path.join(path, name))
    raise FileNotFoundError(f"{path}: no model.safetensors, "
                            "pytorch_model.bin or shard index")


# HF name (per layer i) -> (port name, transpose).
_HF_LAYER = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def weights_from_hf(sd: dict[str, torch.Tensor], cfg: LlamaConfig
                    ) -> dict[str, torch.Tensor]:
    """HF names -> {port parameter name: f32 CPU tensor [in, out]}."""
    def f32(t, transpose=False):
        t = t.float()
        return (t.t() if transpose else t).contiguous()

    out = {"embed": f32(sd["model.embed_tokens.weight"])}
    for i in range(cfg.n_layers):
        for hf_name, (name, transpose) in _HF_LAYER.items():
            out[f"layers.{i}.{name}"] = f32(
                sd[f"model.layers.{i}.{hf_name}"], transpose)
    out["final_norm"] = f32(sd["model.norm.weight"])
    if "lm_head.weight" in sd:
        out["lm_head"] = f32(sd["lm_head.weight"], True)
    else:   # tied embeddings (Llama-3.2-1B/3B style)
        out["lm_head"] = out["embed"].t().contiguous()
    return out


def weights_to_hf(weights: dict[str, torch.Tensor], cfg: LlamaConfig
                  ) -> dict[str, torch.Tensor]:
    """The inverse of weights_from_hf, untied."""
    def t(x, transpose=False):
        x = x.detach().cpu().float()
        return (x.t() if transpose else x).contiguous()

    sd = {"model.embed_tokens.weight": t(weights["embed"]),
          "lm_head.weight": t(weights["lm_head"], True),
          "model.norm.weight": t(weights["final_norm"])}
    for i in range(cfg.n_layers):
        for hf_name, (name, transpose) in _HF_LAYER.items():
            sd[f"model.layers.{i}.{hf_name}"] = t(
                weights[f"layers.{i}.{name}"], transpose)
    return sd


def load_hf_checkpoint(path: str) -> tuple[dict[str, torch.Tensor],
                                           LlamaConfig]:
    """An on-disk HF Llama export -> ({name: f32 CPU tensor}, cfg), the
    weights keyed by Llama.named_parameters() names."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    return weights_from_hf(read_hf_state_dict(path), cfg), cfg


def save_hf_checkpoint(model: Llama, cfg: LlamaConfig, path: str) -> None:
    """Export a model as `config.json` + `model.safetensors` (f32), which
    transformers' LlamaForCausalLM.from_pretrained reads. A mixture of
    experts has no HF Llama form: serve it from its training
    checkpoint."""
    if cfg.n_experts:
        raise ValueError(
            "MoE models have no HF Llama export (HF Llama has no router "
            "or expert stacks); serve a mixture of experts from its "
            "training checkpoint (load_model on the checkpoint dir)")
    os.makedirs(path, exist_ok=True)
    weights = {name: p for name, p in model.named_parameters()}
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        safetensors.write(f, weights_to_hf(weights, cfg))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=2)


# ---------- the CLIs' loading policy ----------

def serving_model(weights: dict[str, torch.Tensor], cfg: LlamaConfig,
                  device: str | torch.device) -> Llama:
    """{Llama.named_parameters() name: tensor} -> a frozen Llama on
    `device`, each weight cast to its decode-path dtype there (the cast
    runs on the device, from the tensor as given)."""
    def w(name):
        return weights[name].to(device).to(decode_dtype(cfg, name.rsplit(
            ".", 1)[-1]))

    layers = [LlamaLayer(**{n: w(f"layers.{i}.{n}")
                            for n in layer_weights(cfg)})
              for i in range(cfg.n_layers)]
    return Llama(cfg, embed=w("embed"), layers=layers,
                 final_norm=w("final_norm"), lm_head=w("lm_head"))


def is_training_checkpoint(path: str) -> bool:
    """A directory holding numeric step dirs with `state/` (the rule
    both packages' checkpoints follow)."""
    return os.path.isdir(path) and any(
        name.isdigit() and os.path.isdir(os.path.join(path, name, "state"))
        for name in os.listdir(path))


def load_model(checkpoint: str | None = None, seed: int = 0,
               device: str | torch.device = "cuda"
               ) -> tuple[Llama, LlamaConfig]:
    """(model, cfg) on `device`: a training checkpoint's newest step or
    an HF export when `checkpoint` is given, else a random llama_tiny
    from `seed`."""
    dev = resolve_device(device)
    if checkpoint:
        if is_training_checkpoint(checkpoint):
            from container_engine_accelerators_tpu_torch.training.checkpoint import (  # noqa: E501
                load_serving_params,
            )
            weights, cfg = load_serving_params(checkpoint)
        else:
            weights, cfg = load_hf_checkpoint(checkpoint)
        return serving_model(weights, cfg, dev), cfg
    cfg = llama_tiny()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, dev), cfg
