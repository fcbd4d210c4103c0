"""Model loading shared by the CLIs, and the HuggingFace Llama format.

`load_model` routes as the JAX package's does: a directory of numeric
step dirs holding `state/` is a training checkpoint
(training/checkpoint.serving_state_file); another directory is an HF
export; no checkpoint gives a random `llama_tiny`. The model comes back
frozen on the device, each weight in its decode-path dtype
(models/llama.py). `checkpoint_weights` reads a checkpoint's config at
once and each weight only when it is looked up, so a loader holds one
weight on the host at a time, and a tensor-parallel rank cuts its shard
from each before it goes to the device.

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

import collections.abc
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


class _LazyTensors(collections.abc.Mapping):
    """{name: CPU tensor} of weight files, each tensor of a `.safetensors`
    file read from it when it is looked up and not kept (a `.bin` file
    is read whole)."""

    def __init__(self, paths: list[str]):
        self._where: dict = {}
        for path in paths:
            if path.endswith(".safetensors"):
                with open(path, "rb") as f:
                    header, start = safetensors.read_header(f)
                for name, info in header.items():
                    self._where[name] = (path, info, start)
            else:
                self._where.update(torch.load(path, map_location="cpu",
                                              weights_only=True))

    def __getitem__(self, name: str) -> torch.Tensor:
        where = self._where[name]
        if isinstance(where, torch.Tensor):
            return where
        path, info, start = where
        with open(path, "rb") as f:
            return safetensors.read_tensor(f, info, start)

    def shape(self, name: str) -> tuple:
        where = self._where[name]
        if isinstance(where, torch.Tensor):
            return tuple(where.shape)
        return tuple(where[1]["shape"])

    def rows(self, name: str, begin: int, end: int) -> torch.Tensor:
        """Rows [begin, end) of a tensor's leading dim; of a
        `.safetensors` tensor only their bytes are read."""
        where = self._where[name]
        if isinstance(where, torch.Tensor):
            return where[begin:end]
        path, info, start = where
        shape = list(info["shape"])
        row = (info["data_offsets"][1] - info["data_offsets"][0]) // shape[0]
        first = info["data_offsets"][0]
        part = dict(info, shape=[end - begin] + shape[1:],
                    data_offsets=[first + begin * row, first + end * row])
        with open(path, "rb") as f:
            return safetensors.read_tensor(f, part, start)

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def _hf_files(path: str) -> list[str]:
    """The weight files of an HF export directory: one `model.safetensors`
    or `pytorch_model.bin`, or the shards `model.safetensors.index.json`
    names."""
    index_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(path, name) for name in files]
    for name in ("model.safetensors", "pytorch_model.bin"):
        if os.path.exists(os.path.join(path, name)):
            return [os.path.join(path, name)]
    raise FileNotFoundError(f"{path}: no model.safetensors, "
                            "pytorch_model.bin or shard index")


def read_hf_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The HF state dict of an export directory (_hf_files), read whole."""
    return dict(_LazyTensors(_hf_files(path)).items())


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


def _hf_names(cfg: LlamaConfig, has_lm_head: bool
              ) -> dict[str, tuple[str, bool]]:
    """{port parameter name: (HF name, transpose)}; without
    `lm_head.weight` the head is the embedding transposed (tied, Llama-3.2
    1B/3B style)."""
    out = {"embed": ("model.embed_tokens.weight", False)}
    for i in range(cfg.n_layers):
        for hf_name, (name, transpose) in _HF_LAYER.items():
            out[f"layers.{i}.{name}"] = (f"model.layers.{i}.{hf_name}",
                                         transpose)
    out["final_norm"] = ("model.norm.weight", False)
    out["lm_head"] = (("lm_head.weight", True) if has_lm_head
                      else ("model.embed_tokens.weight", True))
    return out


def _f32(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    t = t.float()
    return (t.t() if transpose else t).contiguous()


def weights_from_hf(sd: dict[str, torch.Tensor], cfg: LlamaConfig
                    ) -> dict[str, torch.Tensor]:
    """HF names -> {port parameter name: f32 CPU tensor [in, out]}."""
    return {name: _f32(sd[hf], transpose) for name, (hf, transpose)
            in _hf_names(cfg, "lm_head.weight" in sd).items()}


class _PortWeights(collections.abc.Mapping):
    """{port parameter name: f32 CPU tensor [in, out]} over a lazy source,
    each weight read (and transposed where named) when looked up."""

    def __init__(self, source, names: dict[str, tuple[str, bool]]):
        self._source, self._names = source, names

    def __getitem__(self, name: str) -> torch.Tensor:
        src, transpose = self._names[name]
        return _f32(self._source[src], transpose)

    def part(self, name: str, axis: int | None, rank: int, n: int
             ) -> torch.Tensor:
        """Rank `rank`'s block of `n` along `axis` of weight `name` ([in,
        out]; None: the whole weight). Where the block is a run of the
        stored tensor's rows (the output columns of a transposed HF
        weight, the input rows of an untransposed one), only those rows
        are read."""
        src, transpose = self._names[name]
        if axis is None or n == 1:
            return self[name]
        shape = self._source.shape(src)
        stored = (1 - axis) if transpose and len(shape) == 2 else axis
        if stored != 0:
            w = self[name]
            size = w.shape[axis] // n
            return w.narrow(axis, rank * size, size).contiguous()
        size = shape[0] // n
        return _f32(self._source.rows(src, rank * size, (rank + 1) * size),
                    transpose)

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


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

def serving_model(weights, cfg: LlamaConfig, device: str | torch.device,
                  keep=None, read=None) -> Llama:
    """{Llama.named_parameters() name: tensor} -> a frozen Llama on
    `device`, each weight cast to its decode-path dtype there (the cast
    runs on the device, from the tensor as given). The weights are
    looked up one at a time, in the model's order; `keep(short name,
    tensor)`, where given, cuts each one on the host first (a
    tensor-parallel rank's shard); `read(name)`, where given, looks a
    weight up in place of weights[name] (a rank reading its part
    alone)."""
    def w(name):
        short = name.rsplit(".", 1)[-1]
        t = read(name) if read is not None else weights[name]
        if keep is not None:
            t = keep(short, t)
        return t.to(device).to(decode_dtype(cfg, short))

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


def checkpoint_weights(checkpoint: str
                       ) -> tuple[collections.abc.Mapping, LlamaConfig]:
    """(weights, cfg) of a training checkpoint's newest step or an HF
    export. Only the config and the files' headers are read here: each
    weight (an f32 CPU tensor [in, out] under its
    Llama.named_parameters() name) is read when it is looked up, so a
    caller that takes them one at a time holds one weight on the host,
    and one that wants the config alone reads no weight."""
    if is_training_checkpoint(checkpoint):
        from container_engine_accelerators_tpu_torch.training.checkpoint import (  # noqa: E501
            serving_state_file,
        )
        path, cfg = serving_state_file(checkpoint)
        source = _LazyTensors([path])
        return _PortWeights(source, {n: (n, False) for n in source}), cfg
    with open(os.path.join(checkpoint, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    source = _LazyTensors(_hf_files(checkpoint))
    return _PortWeights(source, _hf_names(cfg, "lm_head.weight" in source)
                        ), cfg


def load_model(checkpoint: str | None = None, seed: int = 0,
               device: str | torch.device = "cuda"
               ) -> tuple[Llama, LlamaConfig]:
    """(model, cfg) on `device`: a training checkpoint's newest step or
    an HF export when `checkpoint` is given (checkpoint_weights, one
    weight on the host at a time), else a random llama_tiny from
    `seed`."""
    dev = resolve_device(device)
    if checkpoint:
        weights, cfg = checkpoint_weights(checkpoint)
        return serving_model(weights, cfg, dev), cfg
    cfg = llama_tiny()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, dev), cfg
