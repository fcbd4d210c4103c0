"""The port's vision demos (models/mnist.py, models/resnet.py) against
the JAX package's on the CPU: the same numpy-seeded data and the same
weights (carried across by interop) through both.

Tolerances:
- MNIST forward and loss in f32: 1e-6 (relative to max |logit|; the
  loss relative); 5 Adam steps at the demo's lr 1e-2: the losses within
  1e-5 relative, with a floor of 1e-5 of the first loss. The blobs
  separate in one step and the loss falls to ~1e-6 by the fifth, where
  f32 cross-entropy resolves only ~6e-8 and Adam turns each side's f32
  noise in the near-zero gradients into full-size updates (the weights
  part by 1.6e-4 of their largest |w| after five steps), so the later
  steps are held to the floor (measured 4.4e-8 at most).
- ResNet in f32, train and eval logits: 1e-4 of max |logit| (the
  convolutions sum in other orders: measured up to 1.1e-5); running
  statistics: 1e-5 relative plus 1e-5 absolute (measured up to 2e-6).
- ResNet training, 3 Adam steps' losses: 1e-4 relative.
- ResNet in bf16 (bf16 convolutions and BN application, f32 statistics,
  pool and fc): in eval mode 1e-5 of max |logit| against the JAX
  package's bf16 (measured up to 1.7e-7). In train mode the batch
  statistics are f32 sums in each side's order; a last-bit difference
  can flip the bf16 rounding of a BN scale, and the next layers' batch
  statistics amplify it, in the JAX package's own bf16 run too: on the
  jax.random weights of ResNet-18 at width 8, 32^2, batch 4, the port's
  train logits parted from the JAX bf16 ones by 7.3e-2 of max |logit|,
  and the JAX bf16 ones from its f32 ones by 0.178. So in train mode the
  port's logits are held against the JAX f32 logits: no farther than
  1.5x the JAX bf16 logits are, plus 1e-3 (measured on these weights:
  within 4e-8 of the JAX distance, the two bf16 runs 2.6e-7 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import mnist as jmnist
from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.models import mnist, resnet
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_torch_threads")

LOGIT_RTOL = 1e-4
STAT_TOL = 1e-5
BF16_EVAL_RTOL = 1e-5
BF16_TRAIN_SLACK, BF16_TRAIN_ATOL = 1.5, 1e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------- MNIST ----------

def test_synthetic_mnist_batches_are_the_jax_packages():
    for seed in (0, 3):
        for (x, y), (jx, jy) in zip(mnist.synthetic_mnist(64, 3, seed),
                                    jmnist.synthetic_mnist(64, 3, seed)):
            assert x.dtype == jx.dtype and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_mnist_forward_and_loss_match_jax():
    jparams = jmnist.init_params(jax.random.key(0))
    params = interop.mnist_params_from_jax(jax.device_get(jparams))
    x, y = next(jmnist.synthetic_mnist(128, 1, seed=5))
    jlogits = np.asarray(jmnist.forward(jparams, jnp.asarray(x)))
    logits = mnist.forward(params, torch.from_numpy(x)).detach().numpy()
    assert _rel(logits, jlogits) < 1e-6
    jloss = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(jlogits), jnp.asarray(y)).mean())
    loss = float(mnist.loss_fn(params, torch.from_numpy(x),
                               torch.from_numpy(y)))
    assert abs(loss - jloss) / jloss < 1e-6


def test_mnist_adam_steps_match_jax():
    jparams = jmnist.init_params(jax.random.key(1))
    params = interop.mnist_params_from_jax(jax.device_get(jparams))
    opt = optax.adam(1e-2)
    state = opt.init(jparams)

    @jax.jit
    def jstep(p, s, x, y):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                jmnist.forward(p, x), y).mean()
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    topt = torch.optim.Adam(params.values(), lr=1e-2, betas=(0.9, 0.999),
                            eps=1e-8)
    jlosses, losses = [], []
    for x, y in jmnist.synthetic_mnist(128, 5, seed=0):
        jparams, state, jloss = jstep(jparams, state, x, y)
        jlosses.append(float(jloss))
        loss = mnist.loss_fn(params, torch.from_numpy(x),
                             torch.from_numpy(y))
        topt.zero_grad()
        loss.backward()
        topt.step()
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5,
                               atol=1e-5 * jlosses[0])


def test_mnist_train_runs_on_the_cpu_and_refuses_a_missing_card():
    assert mnist.train(steps=30, batch_size=64, device="cpu") > 0.9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mnist.train(steps=1)


# ---------- ResNet ----------

# (JAX config, port config, image side): the demo's tiny model, a
# ResNet-18 with the 7x7/2 stem and its 3x3/2 max pool (asymmetric SAME
# padding at every stride-2 layer), and a bottleneck ResNet-50 stage
# pair (stride 2 inside the 3x3 of the bottleneck, 1x1/2 projection).
VARIANTS = {
    "tiny": (jresnet.resnet_tiny, resnet.resnet_tiny, {}, 32),
    "resnet18_stem_pool": (jresnet.resnet18, resnet.resnet18,
                           dict(width=8, num_classes=10), 32),
    "resnet50_bottleneck": (jresnet.resnet50, resnet.resnet50,
                            dict(stage_sizes=(1, 1), width=8,
                                 num_classes=10), 32),
}


def _jax_variables(jcfg, seed=0):
    """A variables tree of jresnet.init_variables' structure and shapes
    (traced, not run: drawing it through jax.random costs ~20 s at
    ResNet-18), filled from a numpy seed: He-normal convolutions, scales
    near 1, small biases, running means near 0 and variances in [0.5,
    1.5], so that eval mode normalises by statistics that are not the
    fresh ones."""
    shapes = jax.eval_shape(lambda k: jresnet.init_variables(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['conv']"):
            x = rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif name.endswith("['w']"):
            x = rng.normal(size=shape) * shape[0] ** -0.5
        elif name.endswith("['scale']"):
            x = 1 + 0.1 * rng.normal(size=shape)
        elif name.endswith("['var']"):
            x = rng.uniform(0.5, 1.5, size=shape)
        else:                               # biases and running means
            x = 0.1 * rng.normal(size=shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _variant(name, jdtype=jnp.float32, dtype=torch.float32):
    jbuild, build, kw, hw = VARIANTS[name]
    jcfg, cfg = jbuild(dtype=jdtype, **kw), build(dtype=dtype, **kw)
    variables = _jax_variables(jcfg)
    model = interop.resnet_variables_from_jax(jax.device_get(variables), cfg)
    return jcfg, cfg, variables, model, hw


def _images(hw, n=4, seed=1):
    return (np.random.default_rng(seed).normal(size=(n, hw, hw, 3))
            * 3 + 1).astype(np.float32)


def test_same_padding_is_xlas():
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 1, 2) == (0, 0)
    assert resnet.same_pads(7, 3, 2) == (1, 1)
    assert resnet.same_pads(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_resnet_forward_and_batch_stats_match_jax(name):
    jcfg, cfg, variables, model, hw = _variant(name)
    x = _images(hw)
    japply = jax.jit(jresnet.apply, static_argnums=(2, 3))
    for train in (False, True):
        jlogits, jstats = japply(variables, jnp.asarray(x), jcfg, train)
        logits, _ = resnet.apply(model, torch.from_numpy(x), train=train)
        assert logits.dtype == torch.float32 and logits.shape == (4, 10)
        assert _rel(logits.detach().numpy(), jlogits) < LOGIT_RTOL, train
    got = interop.resnet_variables_to_numpy(model)["batch_stats"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            jax.device_get(jstats))):
        np.testing.assert_allclose(a, b, rtol=STAT_TOL, atol=STAT_TOL)
    # The training forward moved every statistic off its start.
    start = jax.device_get(variables["batch_stats"])
    assert all(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(start)))


def test_resnet_eval_passes_the_statistics_through():
    _, _, variables, model, hw = _variant("tiny")
    before = {k: v.clone() for k, v in model.named_buffers()}
    _, stats = resnet.apply(model, torch.from_numpy(_images(hw)))
    assert all(torch.equal(before[k], v) for k, v in stats.items())


def test_resnet_training_steps_match_jax():
    jcfg, cfg, variables, model, hw = _variant("tiny")
    opt = optax.adam(3e-3)
    jstep = jresnet.make_train_step(jcfg, opt)
    state = (variables, opt.init(variables["params"]))
    step = resnet.make_train_step(model, resnet.make_optimizer(model, 3e-3))
    jlosses, losses = [], []
    for jb, b in zip(jresnet.synthetic_images(jcfg, 8, hw, num_batches=3),
                     resnet.synthetic_images(cfg, 8, hw, num_batches=3)):
        state, jm = jstep(state, jb)
        jlosses.append(float(jm["loss"]))
        losses.append(float(step(b)["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_resnet_bf16_forward_within_its_bound(name):
    jcfg, cfg, variables, model, hw = _variant(name, jnp.bfloat16,
                                               torch.bfloat16)
    jcfg32 = VARIANTS[name][0](dtype=jnp.float32, **VARIANTS[name][2])
    x = _images(hw)
    japply = jax.jit(jresnet.apply, static_argnums=(2, 3))
    for train in (False, True):
        jlogits, _ = japply(variables, jnp.asarray(x), jcfg, train)
        ref, _ = japply(variables, jnp.asarray(x), jcfg32, train)
        logits, _ = resnet.apply(model, torch.from_numpy(x), train=train)
        assert logits.dtype == torch.float32
        got = logits.detach().numpy()
        if not train:
            assert _rel(got, jlogits) < BF16_EVAL_RTOL
        assert _rel(got, ref) <= BF16_TRAIN_SLACK * _rel(
            jlogits, ref) + BF16_TRAIN_ATOL, train


def test_resnet_converter_round_trips_the_jax_tree():
    _, cfg, variables, model, _ = _variant("resnet50_bottleneck")
    want = jax.device_get(variables)
    got = interop.resnet_variables_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert model.stem.conv.shape == (8, 3, 7, 7)
    assert model.stem.conv.is_contiguous(memory_format=torch.channels_last)
    names = dict(model.named_parameters())
    assert {"stem.conv", "stages.0.0.convs.2.conv", "stages.1.0.proj.conv",
            "fc.w", "fc.b"} <= set(names)


def test_synthetic_images_are_the_jax_packages():
    cfg, jcfg = resnet.resnet_tiny(), jresnet.resnet_tiny()
    for b, jb in zip(resnet.synthetic_images(cfg, 6, 16, 2, seed=3),
                     jresnet.synthetic_images(jcfg, 6, 16, 2, seed=3)):
        np.testing.assert_array_equal(b["images"].numpy(),
                                      np.asarray(jb["images"]))
        np.testing.assert_array_equal(b["labels"].numpy(),
                                      np.asarray(jb["labels"]))
        assert b["images"].dtype == torch.float32
        assert b["labels"].dtype == torch.int32


def test_resnet_tiny_learns_synthetic_classes_on_the_cpu():
    """The JAX package's test_learns_synthetic_classes on the port's own
    initialisation: 40 Adam steps at batch 16 halve the loss, and the
    learned running statistics classify fresh data."""
    cfg = resnet.resnet_tiny(dtype=torch.float32)
    torch.manual_seed(0)
    model = resnet.init_variables(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    step = resnet.make_train_step(model, resnet.make_optimizer(model, 3e-3))
    losses = [float(step(b)["loss"]) for b in resnet.synthetic_images(
        cfg, 16, 32, num_batches=40)]
    assert losses[-1] < losses[0] * 0.5, losses[::8]
    batch = next(resnet.synthetic_images(cfg, 32, 32, num_batches=1,
                                         seed=7))
    with torch.no_grad():
        logits, _ = resnet.apply(model, batch["images"], train=False)
    acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
    assert acc > 0.5, acc
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resnet.train(steps=1)
