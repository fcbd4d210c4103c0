"""The port's HF Llama route (models/convert.py) without transformers:
a tiny LlamaForCausalLM saved from a seed loads by hand exactly as the
JAX package's load_hf_checkpoint loads it (f32, tied embeddings too),
its logits match transformers', the port's export loads back into
transformers with equal logits, and load_model routes the three kinds
of source. transformers is used here only to make and read the
reference files."""

import json
import os

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.training import checkpoint as ck
from container_engine_accelerators_tpu_torch.training import train as ttrain

transformers = pytest.importorskip(
    "transformers", reason="the reference HF files are made by transformers")

# f32 on both sides: logits within 1e-4 of the largest |logit|.
LOGITS_TOL = 1e-4
HF = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          max_position_embeddings=128, rms_norm_eps=1e-5,
          rope_theta=500000.0)


def _hf_model(tie: bool, seed: int = 0):
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(tie_word_embeddings=tie, **HF)
    model = transformers.LlamaForCausalLM(cfg).eval()
    with torch.no_grad():   # norms away from one, so a swap shows
        for name, p in model.named_parameters():
            if "norm" in name:
                p.uniform_(0.5, 1.5)
    return model


def _tokens():
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, HF["vocab_size"], size=(2, 16)))


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def _port_logits(weights, cfg, tokens):
    cfg = tllama.dataclasses.replace(cfg, dtype=torch.float32)
    model = convert.serving_model(weights, cfg, "cpu")
    with torch.no_grad():
        return tllama.forward(model, tokens, cfg)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("fmt", ["safetensors", "bin", "sharded"])
def test_hand_read_hf_checkpoint_equals_jax_and_transformers(tmp_path, tie,
                                                             fmt):
    from container_engine_accelerators_tpu.models import convert as jconvert

    hf = _hf_model(tie)
    path = str(tmp_path / "hf")
    if fmt == "sharded":
        hf.save_pretrained(path, max_shard_size="100KB")
        assert os.path.exists(os.path.join(path,
                                           "model.safetensors.index.json"))
    else:
        hf.save_pretrained(path, safe_serialization=fmt == "safetensors")
    weights, cfg = convert.load_hf_checkpoint(path)
    jparams, jcfg = jconvert.load_hf_checkpoint(path)
    for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    np.testing.assert_array_equal(weights["embed"].numpy(), jparams["embed"])
    np.testing.assert_array_equal(weights["lm_head"].numpy(),
                                  jparams["lm_head"])
    np.testing.assert_array_equal(weights["final_norm"].numpy(),
                                  jparams["final_norm"])
    for name, stacked in jparams["layers"].items():
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(
                weights[f"layers.{i}.{name}"].numpy(), stacked[i])
    assert all(w.dtype == torch.float32 for w in weights.values())
    tokens = _tokens()
    with torch.no_grad():
        want = hf(tokens).logits
    assert _rel(_port_logits(weights, cfg, tokens), want) <= LOGITS_TOL


def test_bf16_safetensors_read_by_hand(tmp_path):
    hf = _hf_model(False).to(torch.bfloat16)
    path = str(tmp_path / "hf")
    hf.save_pretrained(path)
    weights, _ = convert.load_hf_checkpoint(path)
    sd = hf.state_dict()
    assert torch.equal(weights["embed"], sd["model.embed_tokens.weight"]
                       .float())
    assert torch.equal(weights["layers.1.wq"],
                       sd["model.layers.1.self_attn.q_proj.weight"]
                       .float().t())


def test_export_loads_in_transformers_with_equal_logits(tmp_path):
    cfg = tllama.llama_tiny(dtype=torch.float32, vocab_size=96, d_model=64,
                            n_heads=4, n_kv_heads=2, d_ff=128)
    model = tllama.init_train_params(cfg, torch.Generator().manual_seed(2),
                                     "cpu")
    path = str(tmp_path / "export")
    convert.save_hf_checkpoint(model, cfg, path)
    hf = transformers.LlamaForCausalLM.from_pretrained(path).eval()
    tokens = _tokens()
    with torch.no_grad():
        want = tllama.forward(model, tokens, cfg)
        got = hf(tokens).logits
    assert _rel(got, want) <= LOGITS_TOL
    # And back by hand, bit for bit.
    weights, cfg2 = convert.load_hf_checkpoint(path)
    for name, p in model.named_parameters():
        assert torch.equal(weights[name], p.detach()), name
    assert json.load(open(os.path.join(path, "config.json")))[
        "num_key_value_heads"] == 2 and cfg2.d_ff == cfg.d_ff


def test_config_from_hf_defaults_and_refusals():
    cfg = convert.config_from_hf({
        "vocab_size": 10, "hidden_size": 8, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 16})
    assert (cfg.n_kv_heads, cfg.max_seq_len, cfg.rope_theta,
            cfg.norm_eps) == (2, 2048, 10000.0, 1e-6)
    with pytest.raises(ValueError, match="head_dim"):
        convert.config_from_hf({
            "vocab_size": 10, "hidden_size": 8, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 16,
            "head_dim": 8})


def test_load_model_routes_three_kinds_of_source(tmp_path):
    # No checkpoint: a random llama_tiny from the seed.
    m0, c0 = convert.load_model(seed=3, device="cpu")
    m1, _ = convert.load_model(seed=3, device="cpu")
    assert c0 == tllama.llama_tiny() and torch.equal(m0.embed, m1.embed)
    # An HF export.
    hf_path = str(tmp_path / "hf")
    _hf_model(False).save_pretrained(hf_path)
    m, c = convert.load_model(hf_path, device="cpu")
    assert c.d_model == HF["hidden_size"] and m.layers[0].wq.dtype == c.dtype
    assert m.lm_head.dtype == torch.float32
    # A training checkpoint (numeric step dirs holding state/).
    cfg = tllama.llama_tiny(dtype=torch.float32, n_layers=1)
    train_model = tllama.init_train_params(
        cfg, torch.Generator().manual_seed(4), "cpu")
    state = ttrain.TrainState(3, train_model, ttrain.make_optimizer()(
        train_model.parameters()))
    ck_path = str(tmp_path / "run")
    ck.CheckpointManager(ck_path, save_interval_steps=1).save(3, state,
                                                              cfg=cfg)
    assert convert.is_training_checkpoint(ck_path)
    assert not convert.is_training_checkpoint(hf_path)
    m, c = convert.load_model(ck_path, device="cpu")
    assert c == cfg and torch.equal(m.layers[0].w_up, train_model.layers[0]
                                    .w_up.detach())
    with pytest.raises(FileNotFoundError):
        convert.load_model(str(tmp_path), device="cpu")
