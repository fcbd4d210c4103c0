"""Port of the mixture-of-experts decode path, held against the JAX
package on the CPU: decode's per-token top-k routing with nothing
dropped (decode._moe_ffn_decode) matches the training forward for a
dropless config and for a capacity config that drops nothing; generate,
the slot, continuous and paged engines (chunked and batched) and
speculation (verify_step, ngram and draft) give JAX generate's greedy
tokens; a checkpoint of the port's fit serves through load_model, an
engine and cli/serve.py's checks; int8 experts, decode-time expert
sharding and ep > 1 raise.

llama_tiny with 4 experts, top-2, in f32, on weights carried across by
interop.params_from_jax. The prompts below are checked for router
margins (the k-th against the (k+1)-th probability) of at least
MIN_MARGIN, so both packages route every token alike."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.models import moe as tmoe
from container_engine_accelerators_tpu_torch.models.convert import (
    load_model,
    save_hf_checkpoint,
)
from container_engine_accelerators_tpu_torch.ops import quant
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import train as ttrain
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

MIN_MARGIN = 1e-4
# f32 both sides, sums in another order through two layers: logits
# within 1e-4 of the largest |logit| (the dense decode tests' bound).
LOGITS_TOL = 1e-4
TIMEOUT = 120
MOE = dict(n_experts=4, moe_top_k=2, moe_dropless=True)
# The engines here cap prompts at 128 tokens, so the decode FFN's switch
# is lowered to 64 (routed_above): LONG's prefill takes the routed
# pairs' path, the others compute every expert.
ROUTED_ABOVE = 64
LONG = ROUTED_ABOVE + 36
MIXED = [([3, 7, 11, 13, 17], 6), ([9, 1, 42], 9),
         (list(np.random.RandomState(5).randint(0, 512, LONG)), 4),
         ([17] * 20, 7), ([2], 12)]


@pytest.fixture(autouse=True)
def routed_above(monkeypatch):
    monkeypatch.setattr(decode, "MOE_ALL_EXPERTS_TOKENS", ROUTED_ABOVE)


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **MOE)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **MOE)
    params = jllama.init_params(jax.random.key(3), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


@pytest.fixture
def router_margins(monkeypatch):
    margins = []
    orig = tmoe._gating

    def spy(logits, top_k):
        out = orig(logits, top_k)
        top = torch.topk(out[0], top_k + 1, dim=-1).values
        margins.append((top[..., top_k - 1] - top[..., top_k]).min().item())
        return out

    monkeypatch.setattr(tmoe, "_gating", spy)
    return margins


_REFERENCE: dict = {}


def direct(pair, tokens, n_new):
    """JAX generate's greedy tokens, computed once a request."""
    key = (tuple(tokens), n_new)
    if key not in _REFERENCE:
        params, jcfg, _, _ = pair
        out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32),
                               jcfg, n_new)
        _REFERENCE[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFERENCE[key]


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("t", [8, LONG])
def test_prefill_matches_training_forward(pair, router_margins, t):
    params, jcfg, model, tcfg = pair
    tokens = np.random.RandomState(t).randint(0, tcfg.vocab_size, (1, t))
    want = np.asarray(jllama.forward(params, jnp.asarray(tokens), jcfg))
    cache = decode.init_cache(tcfg, 1, t, "cpu")
    got, _ = decode.decode_step(model, cache, torch.from_numpy(tokens), tcfg)
    assert min(router_margins) > MIN_MARGIN
    assert _rel(got.numpy(), want) <= LOGITS_TOL
    # The port's own training forward on the same weights.
    fwd = tllama.forward(model, torch.from_numpy(tokens), tcfg)
    assert _rel(got.numpy(), fwd.numpy()) <= LOGITS_TOL


def test_both_ffn_paths_compute_the_same_function(pair):
    _, _, model, tcfg = pair
    h = torch.from_numpy(np.random.RandomState(0).randn(
        2, 40, tcfg.d_model).astype(np.float32))
    layer = model.layers[0]
    every = decode._moe_ffn_decode(h, layer, tcfg)          # 80 tokens
    routed, _ = tmoe.moe_mlp_dropless(h, layer, tcfg)
    assert 2 * 40 > decode.MOE_ALL_EXPERTS_TOKENS
    np.testing.assert_allclose(every.numpy(), routed.numpy(), rtol=1e-6,
                               atol=1e-6)
    few = decode._moe_ffn_decode(h[:, :8], layer, tcfg)     # 16 tokens
    np.testing.assert_allclose(few.numpy(), routed[:, :8].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_generate_matches_jax_and_stepwise_forward(pair, router_margins):
    params, jcfg, model, tcfg = pair
    prompt = [3, 11, 29, 71]
    got = decode.generate(model, torch.tensor([prompt]), tcfg, 6)
    assert got[0].tolist() == direct(pair, prompt, 6)
    seq = list(prompt)
    for _ in range(6):
        logits = tllama.forward(model, torch.tensor([seq]), tcfg)
        seq.append(int(logits[0, -1].argmax()))
    assert got[0].tolist() == seq
    assert min(router_margins) > MIN_MARGIN


def test_capacity_config_decodes_with_the_warning(pair, monkeypatch):
    params, _, model, _ = pair
    kw = dict(n_experts=4, moe_top_k=2, moe_capacity_factor=8.0)
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **kw)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **kw)
    tokens = np.asarray([[5, 17, 203, 9]])
    # capacity_factor 8 drops nothing at S 4: both formulations agree.
    want = np.asarray(jllama.forward(params, jnp.asarray(tokens), jcfg))
    monkeypatch.setattr(decode, "_MOE_DECODE_SKEW_WARNED", False)
    cache = decode.init_cache(tcfg, 1, 4, "cpu")
    with pytest.warns(UserWarning, match="moe_dropless=False"):
        got, _ = decode.decode_step(model, cache, torch.from_numpy(tokens),
                                    tcfg)
    assert _rel(got.numpy(), want) <= LOGITS_TOL
    # Once a process.
    cache = decode.init_cache(tcfg, 1, 4, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        decode.decode_step(model, cache, torch.from_numpy(tokens), tcfg)


def test_slot_path_matches_generate(pair):
    _, _, model, tcfg = pair
    prompt = [3, 7, 11, 13, 17]
    want = direct(pair, prompt, 4)[len(prompt):]
    cache = decode.init_slot_cache(tcfg, 2, 64, "cpu")
    last, cache = decode.prefill_slot(model, cache, 1,
                                      torch.tensor(prompt + [0] * 3), 5,
                                      tcfg)
    toks = [int(last.argmax())]
    for _ in range(3):
        logits, cache = decode.decode_step_slots(
            model, cache, torch.tensor([0, toks[-1]]),
            torch.tensor([False, True]), tcfg)
        toks.append(int(logits[1].argmax()))
    assert toks == want


def _engine(pair, kind, **kw):
    _, _, model, cfg = pair
    if kind == "paged":
        return serve.PagedContinuousEngine(model, cfg, page=16, **kw)
    return serve.ContinuousEngine(model, cfg, prompt_bucket=16, **kw)


def _run(eng, reqs):
    try:
        futs = [eng.submit(list(t), n, 0.0) for t, n in reqs]
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        eng.stop()
        eng.thread.join(timeout=30)


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_engines_match_generate_chunked_and_batched(pair, kind, chunk,
                                                    two_torch_threads):
    eng = _engine(pair, kind, max_slots=3, max_len=256, max_prompt_len=128,
                  prefill_chunk=chunk)
    assert _run(eng, MIXED) == [direct(pair, t, n) for t, n in MIXED]


def test_window_engine_matches_generate(pair, two_torch_threads):
    _, _, model, cfg = pair
    eng = serve.BatchingEngine(model, cfg, max_batch=4, window_ms=50.0)
    reqs = [r for r in MIXED if len(r[0]) < 32]
    assert _run(eng, reqs) == [direct(pair, t, n) for t, n in reqs]


def test_verify_step_matches_single_steps(pair):
    _, _, model, tcfg = pair
    prompt = torch.tensor([[3, 7, 11, 13], [5, 1, 2, 9]])
    on = torch.ones(2, dtype=torch.bool)
    cache = decode.init_slot_cache(tcfg, 2, 16, "cpu")
    _, cache = decode.verify_step(model, cache, prompt, on, tcfg)
    cache = decode.advance_lengths(cache, torch.full((2,), 4,
                                                     dtype=torch.int32), on)
    window = torch.tensor([[8, 4, 4, 2, 9], [1, 1, 7, 3, 3]])
    steps = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                length=cache.length.clone())
    verify, cache = decode.verify_step(model, cache, window, on, tcfg)
    assert cache.length.tolist() == [4, 4]
    single = []
    for j in range(5):
        logits, steps = decode.decode_step(model, steps, window[:, j:j + 1],
                                           tcfg, active=on)
        single.append(logits[:, 0])
    assert _rel(verify.numpy(), torch.stack(single, 1).numpy()) <= 1e-5


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculative_generate_matches_jax_and_plain(pair, mode):
    params, jcfg, model, tcfg = pair
    pattern = [4, 8, 15, 16, 23, 42]
    prompt = np.asarray([pattern * 3, [9, 2, 7, 1] * 4 + [5, 5]])
    want_stats: dict = {}
    want = jdecode.generate(params, jnp.asarray(prompt, jnp.int32), jcfg,
                            10, speculate=mode, spec_k=4, draft_layers=1,
                            spec_stats=want_stats)
    stats: dict = {}
    got = decode.generate(model, torch.from_numpy(prompt), tcfg, 10,
                          speculate=mode, spec_k=4, draft_layers=1,
                          spec_stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == want_stats and stats["verifies"] > 0
    plain = decode.generate(model, torch.from_numpy(prompt), tcfg, 10)
    assert torch.equal(got, plain)


def test_paged_engine_speculates_on_moe(pair, two_torch_threads):
    eng = _engine(pair, "paged", max_slots=2, max_len=128,
                  max_prompt_len=64, speculate="ngram", spec_k=4)
    reqs = [([4, 8, 15, 16] * 4, 10), ([3, 1, 4, 1, 5, 9, 2, 6], 8)]
    assert _run(eng, reqs) == [direct(pair, t, n) for t, n in reqs]


@pytest.fixture(scope="module")
def moe_ckpt(tmp_path_factory):
    """A 2-step fit of an MoE llama_tiny, checkpointed with its config."""
    cfg = tllama.llama_tiny(dtype=torch.float32, vocab_size=64, **MOE)
    d = tmp_path_factory.mktemp("moe_ckpt")
    ttrain.fit(cfg, ttrain.make_optimizer(warmup_steps=1, decay_steps=4),
               tdata.synthetic_batches(cfg.vocab_size, 4, 32, seed=0),
               device="cpu", max_steps=2, log_every=0, ckpt_dir=str(d),
               save_every=1)
    return str(d), cfg


def test_trained_checkpoint_serves(moe_ckpt, two_torch_threads):
    path, cfg = moe_ckpt
    model, cfg2 = load_model(path, device="cpu")
    assert cfg2 == cfg and cfg2.n_experts == 4 and cfg2.moe_dropless
    assert model.layers[0].w_router.dtype == torch.float32
    assert tuple(model.layers[0].w_gate.shape) == (4, cfg.d_model, cfg.d_ff)
    prompt = [3, 7, 11]
    want = decode.generate(model, torch.tensor([prompt]), cfg2, 4)[0]
    eng = serve.ContinuousEngine(model, cfg2, max_slots=2, max_len=64,
                                 prompt_bucket=8, max_prompt_len=32)
    assert _run(eng, [(prompt, 4)]) == [want.tolist()]
    # The weights come back out through params_to_numpy in JAX's layout.
    tree = interop.params_to_numpy(model)
    assert tree["layers"]["w_router"].shape == (2, cfg.d_model, 4)
    assert tree["layers"]["w_down"].shape == (2, 4, cfg.d_ff, cfg.d_model)


def test_serve_refuses_int8_weights_for_moe(moe_ckpt, capsys):
    path, _ = moe_ckpt
    for flags in (["--weight-dtype", "int8"], ["--quantize-int8"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--checkpoint", path, "--device", "cpu", "--port",
                        "0", *flags])
        assert exc.value.code == 2
        assert "not supported for MoE" in capsys.readouterr().err


def test_hf_export_refuses_moe(moe_ckpt, tmp_path):
    path, _ = moe_ckpt
    model, cfg = load_model(path, device="cpu")
    with pytest.raises(ValueError, match="no HF Llama export"):
        save_hf_checkpoint(model, cfg, str(tmp_path / "hf"))


def test_jax_config_record_loads():
    jcfg = jllama.llama_tiny(n_experts=8, moe_top_k=3,
                             moe_capacity_factor=2.0,
                             moe_router="expert_choice",
                             moe_ep_buffer_factor=4.0,
                             moe_ep_dispatch="ragged", moe_aux_weight=0.1,
                             moe_z_weight=0.01)
    cfg = tllama.cfg_from_json_dict(jllama.cfg_to_json_dict(jcfg))
    for f in dataclasses.fields(cfg):
        if f.name.startswith(("n_experts", "moe_")):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def test_int8_experts_decode_ep_and_ep_raise(pair):
    _, _, model, tcfg = pair
    layer = model.layers[0]
    qlayer = tllama.LlamaLayer(**{
        n: getattr(layer, n) for n in tllama.layer_weights(tcfg)
        if n != "w_gate"}, w_gate=quant.quantize_weights(layer.w_gate))
    h = torch.zeros(1, 1, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="int8-quantized"):
        decode._moe_ffn_decode(h, qlayer, tcfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        decode._moe_ffn_decode(h, layer, dataclasses.replace(
            tcfg, moe_decode_ep=True))
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tmoe.moe_mlp_dropless(h, layer, tcfg, ep=2)
