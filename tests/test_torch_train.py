"""Port of the training path, held against the JAX package on the CPU:
the forward logits and loss gradients of a head_dim-128 llama_tiny with
flash attention on and off (JAX's flash in pallas interpret mode), the
remat policies, FusedAdamW and the schedule, three train steps, the data
iterators and the train CLI."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import flash_attention as jfa
from container_engine_accelerators_tpu.training import data as jdata
from container_engine_accelerators_tpu.training import dataset as jdataset
from container_engine_accelerators_tpu.training import train as jtrain
from container_engine_accelerators_tpu.training.fused_adamw import (
    fused_adamw,
)
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import train as tcli
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.ops import flash_attention as tfa
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import (
    dataset as tdataset,
)
from container_engine_accelerators_tpu_torch.training import train as ttrain
from container_engine_accelerators_tpu_torch.training.fused_adamw import (
    FusedAdamW,
    grad_norm_metric,
)

# head_dim 128 and S 256, so flash attention engages on both sides.
SMALL = dict(d_model=256, n_heads=2, n_kv_heads=1)
SEQ = 256
# f32 on both sides, sums in another order: logits within 1e-4 of the
# largest |logit|, the loss within 1e-5 relative, gradients within 1e-4
# of each weight's largest |grad|, parameters after three AdamW steps
# within 1e-5 of each weight's largest |p|.
LOGITS_TOL, LOSS_RTOL, GRAD_TOL, PARAM_TOL = 1e-4, 1e-5, 1e-4, 1e-5


@pytest.fixture
def jax_flash_interpret(monkeypatch):
    """JAX's flash kernel in pallas interpret mode, so it runs here."""
    monkeypatch.setattr(jfa, "flash_attention", functools.partial(
        jfa.flash_attention, interpret=True))


def _configs(**kw):
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL, **kw)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL, **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    tree = jax.device_get(jllama.init_params(jax.random.key(seed), jcfg))
    return tree, interop.train_params_from_jax(tree, tcfg)


def _batch(vocab, b=2, seed=0):
    batch = next(tdata.synthetic_batches(vocab, b, SEQ, seed=seed))
    batch["targets"][0, :5] = -1          # padding is masked out
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss(cfg):
    return lambda params, batch: jtrain.loss_fn(
        params, batch, cfg, lambda x, kind: x, None)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _grads_np(model):
    return interop.params_to_numpy(
        _with_values(model, lambda p: p.grad))


def _with_values(model, fn):
    """A shallow copy of `model` whose weights are fn(weight)."""
    layers = [tllama.LlamaLayer(**{n: fn(getattr(layer, n))
                                   for n in tllama.LlamaLayer.WEIGHTS})
              for layer in model.layers]
    return tllama.Llama(model.cfg, embed=fn(model.embed), layers=layers,
                        final_norm=fn(model.final_norm),
                        lm_head=fn(model.lm_head))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree, np.float32)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_logits_and_loss_grads_match_jax(jax_flash_interpret,
                                                 use_flash):
    jcfg, tcfg = _configs(use_flash=use_flash)
    tree, model = _params(jcfg, tcfg)
    batch = _batch(jcfg.vocab_size)
    want_logits = np.asarray(jllama.forward(tree, jnp.asarray(
        batch["inputs"]), jcfg))
    got_logits = tllama.forward(model, torch.from_numpy(batch["inputs"]),
                                tcfg).detach().numpy()
    assert got_logits.dtype == np.float32
    assert _rel(got_logits, want_logits) <= LOGITS_TOL

    want_loss, want_grads = jax.value_and_grad(_jax_loss(jcfg))(
        tree, batch)
    loss = ttrain.loss_fn(model, _tensors(batch), tcfg)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    got = dict(_flat(_grads_np(model)))
    for name, gw in _flat(jax.device_get(want_grads)):
        assert _rel(got[name], gw) <= GRAD_TOL, name


def test_flash_path_reaches_the_flash_function(monkeypatch):
    # use_flash=True at head_dim 128 runs the port's flash attention;
    # None on the CPU does not.
    _, tcfg = _configs(use_flash=True)
    _, model = _params(*_configs())
    calls = []
    orig = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("causal_grid"))
        return orig(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    tokens = torch.zeros((1, SEQ), dtype=torch.long)
    tllama.forward(model, tokens, dataclasses.replace(
        tcfg, flash_causal_grid="tri"))
    assert calls == ["tri"] * tcfg.n_layers
    tllama.forward(model, tokens, dataclasses.replace(tcfg, use_flash=None))
    assert len(calls) == tcfg.n_layers


@pytest.mark.parametrize("policy", ["dots", "dots_all", "full"])
def test_remat_policies_give_identical_gradients(policy):
    _, tcfg = _configs(use_flash=True)
    batch = _tensors(_batch(tcfg.vocab_size, b=1))
    grads = {}
    for name in ("none", policy):
        cfg = dataclasses.replace(tcfg, remat_policy=name)
        model = tllama.init_train_params(
            cfg, torch.Generator().manual_seed(0), "cpu")
        ttrain.loss_fn(model, batch, cfg).backward()
        grads[name] = [p.grad for p in model.parameters()]
    for a, b in zip(grads["none"], grads[policy]):
        assert torch.equal(a, b)


def test_unported_and_unknown_configs_raise():
    _, tcfg = _configs()
    model = tllama.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                     "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    for kw, err in (({"remat_policy": "dots_save_attn"}, NotImplementedError),
                    ({"remat_policy": "nothing"}, ValueError),
                    ({"flash_causal_grid": "triangular"}, ValueError)):
        with pytest.raises(err):
            tllama.forward(model, tokens, dataclasses.replace(tcfg, **kw))


def test_train_params_round_trip_and_flops_match_jax():
    jcfg, tcfg = _configs()
    tree, model = _params(jcfg, tcfg)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = dict(_flat(interop.params_to_numpy(model)))
    for name, want in _flat(tree):
        np.testing.assert_array_equal(back[name], want)
    for preset in ("llama3_8b", "llama3_1b", "llama_tiny"):
        j, t = getattr(jllama, preset)(), getattr(tllama, preset)()
        assert t.train_flops_per_token(2048) == j.train_flops_per_token(2048)
    n = sum(p.numel() for p in tllama.init_train_params(
        tcfg, torch.Generator().manual_seed(0), "cpu").parameters())
    assert n == tcfg.num_params()


def _opt_tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(16, 8).astype(np.float32),
            "b": rs.randn(4, 4, 4).astype(np.float32),
            "c": rs.randn(8).astype(np.float32)}


@pytest.mark.parametrize("grad_scale,mu_dtype", [(1.0, None), (100.0, None),
                                                 (100.0, "bfloat16")])
def test_fused_adamw_matches_jax(grad_scale, mu_dtype):
    # grad_scale 100 pushes the global norm past the clip of 1.
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, 3e-2, warmup_steps=1, decay_steps=10, end_value=3e-3)
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0)
    jopt = fused_adamw(schedule, **kw, mu_dtype=mu_dtype and jnp.bfloat16)
    params = _opt_tree(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = FusedAdamW(tparams.values(),
                      lr=ttrain.warmup_cosine_decay_schedule(
                          0.0, 3e-2, 1, 10, 3e-3),
                      mu_dtype=mu_dtype and torch.bfloat16, **kw)
    for step in range(3):
        grads = {k: v * grad_scale for k, v in _opt_tree(step + 1).items()}
        updates, jstate = jopt.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
        assert abs(topt.gnorm.item() - float(jstate.gnorm)) <= 1e-6 * float(
            jstate.gnorm)
    assert topt.count == int(jstate.count) == 3
    for k, p in tparams.items():
        assert _rel(p.detach().numpy(), np.asarray(jparams[k])) <= PARAM_TOL
        st = topt.state[p]
        assert st["mu"].dtype == (torch.bfloat16 if mu_dtype
                                  else torch.float32)
        # The moments: f32 sums in another order, or one bf16 ulp.
        mu_tol = 2 ** -8 if mu_dtype else 1e-6
        assert _rel(st["mu"].float().numpy(), np.asarray(
            jstate.mu[k].astype(jnp.float32))) <= mu_tol
        assert _rel(st["nu"].numpy(), np.asarray(jstate.nu[k])) <= 1e-6


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, warmup_steps=100, decay_steps=10_000, end_value=3e-5)
    got = ttrain.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000, 3e-5)
    for count in (0, 1, 50, 99, 100, 101, 5_000, 9_999, 10_000, 20_000):
        assert abs(got(count) - float(want(count))) <= 1e-6 * 3e-4, count
    fn = ttrain.make_optimizer()
    assert fn.keywords["lr"](100) == pytest.approx(3e-4)


def test_grad_norm_metric_reads_the_optimizer_or_reduces():
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    opt = FusedAdamW([p], lr=0.0)
    want = float(np.sqrt(12.0))
    assert grad_norm_metric(torch.optim.SGD([p], lr=0.0),
                            [p.grad]).item() == pytest.approx(want)
    opt.step()
    assert grad_norm_metric(opt, []) is opt.gnorm
    assert opt.gnorm.item() == pytest.approx(want)


def test_three_train_steps_match_jax(jax_flash_interpret):
    jcfg, tcfg = _configs(use_flash=True)
    tree, model = _params(jcfg, tcfg)
    # Adam divides each gradient by its own magnitude, so an element
    # whose gradient is f32 noise (~1e-9 against a largest |g| of ~4)
    # would move by a random fraction of lr on each side. eps 1e-5 holds
    # such elements still and leaves every real gradient normalized.
    kw = dict(b1=0.9, b2=0.95, eps=1e-5, weight_decay=0.1, grad_clip=1.0)
    jopt = fused_adamw(1e-4, **kw)
    jstate = jopt.init(tree)
    topt = FusedAdamW(model.parameters(), lr=1e-4, **kw)
    step = ttrain.make_train_step(tcfg, topt)
    jgrad = jax.jit(jax.value_and_grad(_jax_loss(jcfg)))
    jparams = tree
    for i, batch in enumerate(tdata.synthetic_batches(
            tcfg.vocab_size, 2, SEQ, num_batches=3, seed=1)):
        loss, grads = jgrad(jparams, batch)
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        metrics = step(model, _tensors(batch))
        assert abs(metrics["loss"].item() - float(loss)) <= LOSS_RTOL * abs(
            float(loss)), i
        assert metrics["tokens"].item() == 2 * SEQ
        assert metrics["grad_norm"].item() == pytest.approx(
            float(jstate.gnorm), rel=1e-5)
    got = dict(_flat(interop.params_to_numpy(model)))
    for name, want in _flat(jax.device_get(jparams)):
        assert _rel(got[name], want) <= PARAM_TOL, name


def test_grad_accum_averages_microbatch_gradients():
    _, tcfg = _configs()
    batch = _tensors(_batch(tcfg.vocab_size, b=2))
    grads, losses = [], []
    for accum in (1, 2):
        model = tllama.init_train_params(
            tcfg, torch.Generator().manual_seed(0), "cpu")
        opt = FusedAdamW(model.parameters(), lr=0.0)
        metrics = ttrain.make_train_step(tcfg, opt, grad_accum=accum)(
            model, batch)
        grads.append([p.grad for p in model.parameters()])
        losses.append(metrics["loss"].item())
    # Row 0 has 5 masked targets, so the microbatch mean differs from the
    # full-batch mean; with equal counts they agree.
    full = _tensors(next(tdata.synthetic_batches(tcfg.vocab_size, 2, SEQ)))
    m1 = tllama.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    m2 = tllama.init_train_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
    s1 = ttrain.make_train_step(tcfg, FusedAdamW(m1.parameters(), lr=0.0))
    s2 = ttrain.make_train_step(tcfg, FusedAdamW(m2.parameters(), lr=0.0),
                                grad_accum=2)
    l1, l2 = s1(m1, full)["loss"].item(), s2(m2, full)["loss"].item()
    assert l1 == pytest.approx(l2, rel=1e-6)
    for a, b in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        s2(m2, {k: v[:1] for k, v in full.items()})


def test_fit_trains_on_the_cpu_and_tracks_the_step_on_the_host():
    cfg = tllama.llama_tiny(dtype=torch.float32)
    logs = []
    state, metrics = ttrain.fit(
        cfg, ttrain.make_optimizer(learning_rate=1e-2, warmup_steps=1),
        tdata.synthetic_batches(cfg.vocab_size, 4, 32, seed=0),
        device="cpu", max_steps=4, log_every=2, log_fn=logs.append)
    assert state.step == 4 and state.tokens == 4 * 4 * 32
    assert state.optimizer.count == 4
    assert [m.split()[:2] for m in logs] == [["step", "1"], ["step", "3"]]
    assert np.isfinite(metrics["loss"].item())
    # A stream that ends first stops the loop.
    state, _ = ttrain.fit(cfg, ttrain.make_optimizer(),
                          tdata.synthetic_batches(cfg.vocab_size, 2, 16,
                                                  num_batches=2),
                          device="cpu", max_steps=10, log_every=0)
    assert state.step == 2


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_equal_jax(seed):
    for j, t in zip(jdata.synthetic_batches(300, 3, 17, num_batches=3,
                                            seed=seed),
                    tdata.synthetic_batches(300, 3, 17, num_batches=3,
                                            seed=seed)):
        for key in ("inputs", "targets"):
            assert j[key].dtype == t[key].dtype
            np.testing.assert_array_equal(j[key], t[key])


@pytest.mark.parametrize("vocab", [256, 70_000])
def test_token_files_and_batches_equal_jax(tmp_path, vocab):
    tokens = np.random.RandomState(0).randint(0, vocab, size=5_000)
    jpath, tpath = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jdataset.write_token_file(tokens, jpath, vocab)
    tdataset.write_token_file(tokens, tpath, vocab)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert json.load(open(jpath + ".json")) == json.load(
        open(tpath + ".json"))
    kw = dict(batch_size=4, seq_len=33, process_id=1, num_processes=2,
              seed=3, num_batches=5)
    got = list(tdataset.token_file_batches(jpath, **kw))
    want = list(jdataset.token_file_batches(tpath, **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(g[key], w[key])
    assert tdataset.TokenDataset(jpath).vocab_size == vocab
    np.testing.assert_array_equal(tdataset.encode_bytes("héllo"),
                                  jdataset.encode_bytes("héllo"))


def test_train_cli_on_the_cpu_prints_its_json_line(capsys, tmp_path):
    assert tcli.main(["--device", "cpu", "--preset", "tiny", "--steps",
                      "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == out["steps"] == 2
    assert out["tokens"] == 2 * 8 * 128
    assert out["tokens_per_sec"] > 0 and np.isfinite(out["loss"])
    path = str(tmp_path / "toks.bin")
    tdataset.write_token_file(np.arange(3_000) % 512, path, 512)
    assert tcli.main(["--device", "cpu", "--data", path, "--steps", "1",
                      "--batch-size", "2", "--seq-len", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 2 * 64
