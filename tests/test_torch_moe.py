"""Port of models/moe.py at one rank, held against the JAX package on the
CPU: the capacity formula, capacity and expert-choice routing, moe_mlp
and moe_mlp_dropless (outputs and MoeMetrics), forward's router aux
under every remat policy, the gradients of loss plus aux, a 2-step fit
and the memory plans of an MoE config.

Weights and activations are drawn with numpy from a seed and carried to
both sides. Routing must agree exactly, so every test that compares
against JAX asserts that its data holds no router margin (the k-th
against the (k+1)-th probability) under MIN_MARGIN: torch.topk does not
promise JAX's lower-index-first order on ties."""

import contextlib
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.models import moe as jmoe
from container_engine_accelerators_tpu.training import train as jtrain
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.models import moe as tmoe
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import train as ttrain
from container_engine_accelerators_tpu_torch.utils import hbm_plan
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401
from tools import hbm_plan as jplan

MIN_MARGIN = 1e-4
# f32 on both sides, sums in another order. MoE FFN outputs and forward
# logits within OUT_TOL of the largest |value| (abs and rel), the
# scalar metrics within METRIC_RTOL, the gradients of loss plus aux
# within GRAD_TOL of each weight's largest |grad|.
OUT_TOL, METRIC_RTOL, GRAD_TOL = 2e-5, 1e-5, 1e-4
REMAT = ("none", "dots", "dots_all", "full", "dots_save_attn")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture
def router_margins(monkeypatch):
    """Every top-k the port's routers take, recorded as the least margin
    between a token's k-th and (k+1)-th probability."""
    margins = []
    orig = tmoe._gating

    def spy(logits, top_k):
        out = orig(logits, top_k)
        if top_k < logits.shape[-1]:
            top = torch.topk(out[0].detach(), top_k + 1, dim=-1).values
            margins.append((top[..., top_k - 1] - top[..., top_k])
                           .min().item())
        return out

    monkeypatch.setattr(tmoe, "_gating", spy)
    return margins


def _weights(seed, d, f, e, router_scale=0.1, scale=0.05):
    rs = np.random.RandomState(seed)
    return {"w_router": (rs.randn(d, e) * router_scale).astype(np.float32),
            "w_gate": (rs.randn(e, d, f) * scale).astype(np.float32),
            "w_up": (rs.randn(e, d, f) * scale).astype(np.float32),
            "w_down": (rs.randn(e, f, d) * scale).astype(np.float32)}


def _ns(lp):
    """Weights as a layer's attributes, as moe.py reads them."""
    return types.SimpleNamespace(**lp)


def _both(lp):
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v) for k, v in lp.items()})


def _cfgs(**kw):
    return (jllama.llama_tiny(dtype=jnp.float32, **kw),
            tllama.llama_tiny(dtype=torch.float32, **kw))


def _h(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@contextlib.contextmanager
def _quiet():
    """The expert-choice and dots_save_attn warnings, silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _metrics_close(got, want):
    for name in ("aux_loss", "router_z_loss", "dropped_fraction"):
        g, w = float(getattr(got, name)), float(getattr(want, name))
        assert abs(g - w) <= METRIC_RTOL * max(abs(w), 1.0), name


# ---------- capacity and routing ----------

def test_capacity_formula():
    assert tmoe.capacity(seq_len=64, n_experts=4, top_k=2,
                         capacity_factor=1.0) == 32
    assert tmoe.capacity(seq_len=4, n_experts=8, top_k=2,
                         capacity_factor=1.0) == 2      # floor at top_k
    for s in (1, 7, 64, 1024):
        for e in (1, 4, 8):
            for k in (1, 2):
                for cf in (0.5, 1.0, 1.25, 4.0):
                    assert tmoe.capacity(s, e, k, cf) == jmoe.capacity(
                        s, e, k, cf)


def _logits_cases():
    rs = np.random.RandomState(0)
    skew = np.zeros((1, 8, 2), np.float32)
    skew[..., 0] = 10.0
    balanced = np.stack([np.eye(4, dtype=np.float32)[np.arange(16) % 4]
                         * 10.0] * 2)
    return {"all_to_expert_0": (skew, 1, 4),
            "balanced": (balanced, 1, 8),
            "random_top2": (rs.randn(2, 16, 4).astype(np.float32), 2, 5),
            "random_top2_tight": (rs.randn(3, 32, 8).astype(np.float32), 2,
                                  4)}


@pytest.mark.parametrize("case", sorted(_logits_cases()))
def test_route_matches_jax(case):
    logits, k, cap = _logits_cases()[case]
    e = logits.shape[-1]
    jd, jc, jm = jmoe.route(jnp.asarray(logits), e, k, cap)
    td, tc, tm = tmoe.route(torch.from_numpy(logits), e, k, cap)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    _metrics_close(tm, jm)
    # Each expert holds at most `cap` tokens a row, and a dropped
    # token's combine weights are all zero.
    assert _np(td).sum(axis=(1, 3)).max() <= cap
    if case == "all_to_expert_0":
        per_token = _np(tc).sum(axis=(2, 3))[0]
        assert (per_token[:cap] > 0.99).all()
        assert (per_token[cap:] < 1e-6).all()
        assert float(tm.dropped_fraction) == pytest.approx(0.5)
    if case == "balanced":
        assert float(tm.dropped_fraction) == pytest.approx(0.0, abs=1e-6)
        assert 0.9 < float(tm.aux_loss) < 1.3


@pytest.mark.parametrize("cap", [4, 8, 40])
def test_route_expert_choice_matches_jax(cap):
    logits = np.random.RandomState(1).randn(2, 16, 4).astype(np.float32)
    jd, jc, jm = jmoe.route_expert_choice(jnp.asarray(logits), cap)
    td, tc, tm = tmoe.route_expert_choice(torch.from_numpy(logits), cap)
    # Token ties inside an expert's column would make top-C ambiguous.
    probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), axis=1)
    assert np.diff(probs, axis=1).min() > MIN_MARGIN
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    _metrics_close(tm, jm)
    # Every expert is exactly full (cap clamped to S).
    np.testing.assert_array_equal(_np(td).sum(axis=(1, 3)), min(cap, 16))
    assert float(tm.aux_loss) == 0.0


def test_expert_choice_balanced_under_adversarial_router():
    logits = np.zeros((2, 16, 4), np.float32)
    logits[..., 0] = 10.0
    _, _, tc = tmoe.route(torch.from_numpy(logits), 4, 1, 4)
    assert float(tc.dropped_fraction) >= 0.5
    dispatch, _, _ = tmoe.route_expert_choice(torch.from_numpy(logits), 4)
    np.testing.assert_array_equal(_np(dispatch).sum(axis=(1, 3)), 4)


# ---------- the MoE FFN ----------

MLP_CASES = {
    "capacity": dict(n_experts=4, moe_top_k=2, moe_capacity_factor=1.0),
    "capacity_top1": dict(n_experts=4, moe_top_k=1,
                          moe_capacity_factor=1.25),
    "expert_choice": dict(n_experts=4, moe_top_k=2,
                          moe_router="expert_choice"),
    "dropless": dict(n_experts=4, moe_top_k=2, moe_dropless=True),
    "dropless_top3_of_8": dict(n_experts=8, moe_top_k=3,
                               moe_dropless=True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_jax(case, router_margins):
    kw = MLP_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    jlp, tlp = _both(_weights(2, jcfg.d_model, jcfg.d_ff, kw["n_experts"]))
    h = _h(3, (2, 16, jcfg.d_model))
    jfn = jmoe.moe_mlp_dropless if tcfg.moe_dropless else jmoe.moe_mlp
    tfn = tmoe.moe_mlp_dropless if tcfg.moe_dropless else tmoe.moe_mlp
    with pytest.warns(UserWarning, match="non-causally") if (
            case == "expert_choice") else contextlib.nullcontext():
        tout, tm = tfn(torch.from_numpy(h), _ns(tlp), tcfg)
    jout, jm = jfn(jnp.asarray(h), jlp, jcfg)
    if case != "expert_choice":
        assert min(router_margins) > MIN_MARGIN
    assert _rel(_np(tout), jout) <= OUT_TOL
    _metrics_close(tm, jm)
    if case.startswith("capacity"):
        assert float(tm.dropped_fraction) > 0.0   # the cases do drop


@pytest.mark.parametrize("kw", [
    dict(moe_capacity_factor=1.0),
    dict(moe_dropless=True),
    dict(moe_router="expert_choice", moe_capacity_factor=1.0),
], ids=["capacity", "dropless", "expert_choice"])
def test_single_expert_equals_dense(kw):
    _, cfg = _cfgs(n_experts=1, moe_top_k=1, **kw)
    d, f = cfg.d_model, cfg.d_ff
    lp = {k: torch.from_numpy(v) for k, v in _weights(1, d, f, 1).items()}
    lp["w_router"] = torch.zeros(d, 1)
    h = torch.from_numpy(_h(0, (2, 8, d)))
    fn = tmoe.moe_mlp_dropless if cfg.moe_dropless else tmoe.moe_mlp
    with _quiet():
        out, metrics = fn(h, _ns(lp), cfg)
    dense = (torch.nn.functional.silu(h @ lp["w_gate"][0])
             * (h @ lp["w_up"][0])) @ lp["w_down"][0]
    np.testing.assert_allclose(_np(out), _np(dense), rtol=1e-5, atol=1e-5)
    assert float(metrics.dropped_fraction) == pytest.approx(0.0, abs=1e-6)


def test_dropless_matches_capacity_when_nothing_drops(router_margins):
    _, cfg_cap = _cfgs(n_experts=4, moe_top_k=2, moe_capacity_factor=4.0)
    _, cfg_dl = _cfgs(n_experts=4, moe_top_k=2, moe_dropless=True)
    d, f = cfg_cap.d_model, cfg_cap.d_ff
    lp = {k: torch.from_numpy(v) for k, v in _weights(1, d, f, 4).items()}
    h = torch.from_numpy(_h(0, (2, 16, d)))
    out_cap, m_cap = tmoe.moe_mlp(h, _ns(lp), cfg_cap)
    out_dl, m_dl = tmoe.moe_mlp_dropless(h, _ns(lp), cfg_dl)
    assert min(router_margins) > MIN_MARGIN
    assert float(m_cap.dropped_fraction) == pytest.approx(0.0, abs=1e-6)
    np.testing.assert_allclose(_np(out_dl), _np(out_cap), rtol=1e-5,
                               atol=1e-5)
    assert float(m_dl.aux_loss) == pytest.approx(float(m_cap.aux_loss),
                                                 rel=1e-6)


def test_dropless_never_drops_under_imbalance():
    _, cfg_cap = _cfgs(n_experts=4, moe_top_k=1, moe_capacity_factor=1.0)
    _, cfg_dl = _cfgs(n_experts=4, moe_top_k=1, moe_dropless=True)
    d, f = cfg_cap.d_model, cfg_cap.d_ff
    lp = {k: torch.from_numpy(v) for k, v in _weights(1, d, f, 4).items()}
    lp["w_router"] = torch.zeros(d, 4)
    lp["w_router"][:, 0] = 1.0
    h = torch.from_numpy(_h(0, (2, 16, d)))
    out_cap, m_cap = tmoe.moe_mlp(h, _ns(lp), cfg_cap)
    out_dl, m_dl = tmoe.moe_mlp_dropless(h, _ns(lp), cfg_dl)
    assert float(m_cap.dropped_fraction) >= 0.5
    assert float(m_dl.dropped_fraction) == 0.0
    # No token passes through with a zero FFN output.
    assert _np(out_dl).reshape(-1, d).any(axis=1).all()
    assert not _np(out_cap).reshape(-1, d).any(axis=1).all()


def test_dropless_combine_is_deterministic_and_ep_raises():
    _, cfg = _cfgs(n_experts=4, moe_top_k=2, moe_dropless=True)
    d, f = cfg.d_model, cfg.d_ff
    lp = {k: torch.from_numpy(v) for k, v in _weights(4, d, f, 4).items()}
    h = torch.from_numpy(_h(5, (2, 16, d)))
    a, _ = tmoe.moe_mlp_dropless(h, _ns(lp), cfg)
    b, _ = tmoe.moe_mlp_dropless(h, _ns(lp), cfg)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        tmoe.moe_mlp_dropless(h, _ns(lp), cfg, ep=2)


def test_router_config_validation():
    _, cfg = _cfgs(n_experts=2, moe_router="expert-choice")
    lp = {k: torch.from_numpy(v)
          for k, v in _weights(0, cfg.d_model, cfg.d_ff, 2).items()}
    with pytest.raises(ValueError, match="unknown moe_router"):
        tmoe.moe_mlp(torch.zeros(1, 4, cfg.d_model), _ns(lp), cfg)
    _, cfg2 = _cfgs(n_experts=2, moe_dropless=True,
                    moe_router="expert_choice")
    model = tllama.init_train_params(cfg2, torch.Generator().manual_seed(0),
                                     "cpu")
    with pytest.raises(ValueError, match="already dropless"):
        tllama.forward(model, torch.zeros(2, 8, dtype=torch.long), cfg2)


def test_expert_choice_capacity_clamped_to_sequence():
    _, cfg = _cfgs(n_experts=2, moe_top_k=2, moe_capacity_factor=1.25,
                   moe_router="expert_choice")
    lp = {k: torch.from_numpy(v)
          for k, v in _weights(1, cfg.d_model, cfg.d_ff, 2).items()}
    with _quiet():
        out, _ = tmoe.moe_mlp(torch.from_numpy(_h(0, (2, 8, cfg.d_model))),
                              _ns(lp), cfg)
    assert torch.isfinite(out).all()


# ---------- the model: config, init, forward, gradients, fit ----------

def test_config_params_and_init_match_jax():
    kw = dict(n_experts=4, moe_top_k=2, moe_dropless=True)
    jcfg, tcfg = _cfgs(**kw)
    assert tcfg.num_params() == jcfg.num_params()
    assert tllama.llama3_8b(n_experts=8).num_params() == jllama.llama3_8b(
        n_experts=8).num_params()
    # The per-token FLOPs count one FFN a token in both packages.
    assert tcfg.train_flops_per_token(64) == jcfg.train_flops_per_token(64)
    # JAX's config record loads, and the port's round-trips.
    d = jllama.cfg_to_json_dict(jcfg)
    assert tllama.cfg_from_json_dict(d) == tcfg
    assert tllama.cfg_from_json_dict(tllama.cfg_to_json_dict(tcfg)) == tcfg
    model = tllama.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    assert sum(p.numel() for p in model.parameters()) == tcfg.num_params()
    tree = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    layer = model.layers[0]
    for name in ("w_router", "w_gate", "w_up", "w_down"):
        want = tree["layers"][name]
        assert tuple(getattr(layer, name).shape) == want.shape[1:], name
        # The same fan-in scale: the two stds within 10%.
        assert _np(getattr(layer, name)).std() == pytest.approx(
            np.asarray(want).std(), rel=0.1), name
    frozen = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert frozen.layers[0].w_router.dtype == torch.float32


def _pair(seed=3, **kw):
    jcfg, tcfg = _cfgs(n_experts=4, moe_top_k=2, **kw)
    tree = jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))
    return tree, jcfg, interop.train_params_from_jax(tree, tcfg), tcfg


ROUTINGS = {"dropless": dict(moe_dropless=True),
            "capacity": dict(moe_capacity_factor=1.0),
            "expert_choice": dict(moe_router="expert_choice")}


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("routing", ["dropless", "capacity"])
def test_forward_logits_and_aux_match_jax(routing, policy, router_margins,
                                          two_torch_threads):
    tree, jcfg, model, tcfg = _pair(**ROUTINGS[routing])
    jcfg = dataclasses.replace(jcfg, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, remat_policy=policy)
    tokens = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 16))
    with _quiet():
        want, want_aux = jllama.forward(tree, jnp.asarray(tokens), jcfg,
                                        return_aux=True)
        got, aux = tllama.forward(model, torch.from_numpy(tokens), tcfg,
                                  return_aux=True)
    assert min(router_margins) > MIN_MARGIN
    assert _rel(_np(got), want) <= OUT_TOL
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert aux.item() > 0
    assert aux.item() == pytest.approx(float(want_aux), rel=METRIC_RTOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree, np.float32)


def _grads_np(model):
    layers = [tllama.LlamaLayer(**{
        n: getattr(layer, n).grad for n in tllama.layer_weights(model.cfg)})
        for layer in model.layers]
    return interop.params_to_numpy(tllama.Llama(
        model.cfg, embed=model.embed.grad, layers=layers,
        final_norm=model.final_norm.grad, lm_head=model.lm_head.grad))


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_loss_plus_aux_gradients_match_jax(routing, router_margins,
                                           two_torch_threads):
    tree, jcfg, model, tcfg = _pair(seed=4, remat_policy="dots",
                                    **ROUTINGS[routing])
    jcfg = dataclasses.replace(jcfg, remat_policy="dots")
    batch = next(tdata.synthetic_batches(tcfg.vocab_size, 2, 16, seed=1))
    batch["targets"][0, :3] = -1
    with _quiet():
        want_loss, want_grads = jax.value_and_grad(
            lambda p, b: jtrain.loss_fn(p, b, jcfg, lambda x, kind: x,
                                        None))(tree, batch)
        loss = ttrain.loss_fn(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, tcfg)
    loss.backward()
    if routing != "expert_choice":
        assert min(router_margins) > MIN_MARGIN
    assert loss.item() == pytest.approx(float(want_loss), rel=METRIC_RTOL)
    got = dict(_flat(_grads_np(model)))
    want = dict(_flat(jax.device_get(want_grads)))
    assert set(got) == set(want)
    for name in ("layers/w_router", "layers/w_gate", "layers/w_up",
                 "layers/w_down"):
        assert np.abs(want[name]).max() > 0, name
    for name, gw in want.items():
        assert _rel(got[name], gw) <= GRAD_TOL, name


def test_fit_two_steps_stays_finite(two_torch_threads):
    _, cfg = _cfgs(n_experts=4, moe_top_k=2, moe_dropless=True,
                   vocab_size=64)
    logs = []
    opt = ttrain.make_optimizer(learning_rate=5e-3, warmup_steps=1,
                                decay_steps=10)
    state, metrics = ttrain.fit(
        cfg, opt, tdata.synthetic_batches(cfg.vocab_size, 4, 32, seed=0),
        device="cpu", max_steps=2, log_every=1, log_fn=logs.append)
    assert state.step == 2
    assert np.isfinite(float(metrics["loss"]))
    for p in state.model.parameters():
        assert torch.isfinite(p).all()


# ---------- memory plans ----------

@pytest.mark.parametrize("kw", [
    dict(n_experts=8, moe_top_k=2, moe_dropless=True, n_layers=16),
    dict(n_experts=8, moe_top_k=2, n_layers=2),
    dict(n_experts=4, moe_top_k=1, moe_decode_ep=True),
], ids=["mixtral_ffn_16", "mixtral_ffn_2", "decode_ep"])
def test_plans_equal_tools_hbm_plan(kw):
    tcfg, jcfg = tllama.llama3_8b(**kw), jllama.llama3_8b(**kw)
    chip = "v5p"
    cap = jplan.CHIP_HBM[chip]
    for tp in (1, 2):
        for frac in (0.5, 1.0):
            args = dict(tp=tp, max_slots=8, max_len=2048,
                        pool_fraction=frac)
            assert hbm_plan.plan_serving(
                tcfg, chip=chip, hbm_bytes=cap, **args) == \
                jplan.plan_serving(jcfg, chip=chip, **args), args
    for mesh in ({}, {"ep": 2}, {"ep": 2, "fsdp": 2}):
        args = dict(batch_size=2, seq_len=1024, **mesh)
        assert hbm_plan.plan_training(
            tcfg, chip=chip, hbm_bytes=cap, **args) == \
            jplan.plan_training(jcfg, chip=chip, **args), args
