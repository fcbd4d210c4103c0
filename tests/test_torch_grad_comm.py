"""Port of parallel/grad_comm.py and ops/quant.py's gradient
quantizers, held against the JAX package on the CPU: the bucket
partitioner and the wire-byte ledger (tests/test_dcn_overlap.py's cases
through both packages), quantize_grads / dequantize_grads (integers
equal, scales within 1 ulp), error feedback cancelling the one-step
bias, the overlap mesh checks, and the reduced gradients of 4 gloo rank
processes (dp 2 x fsdp 2) against the JAX overlap step on a 4-device
(dp 2, fsdp 2) mesh, f32, compress 'none' (also at grad_accum 2) and
'int8'. Tolerance: within 1e-5 of each leaf's largest |grad|; under
int8 an element may also part by one quantization step (the leaf's
largest slot absmax / 127, over the mean's denominator) where the two
packages' f32 sums put it on opposite sides of a rounding boundary, and
at most 1 in 1000 elements may."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.ops import quant as jquant
from container_engine_accelerators_tpu.parallel import grad_comm as jgc
from container_engine_accelerators_tpu.parallel import mesh as jmesh
from container_engine_accelerators_tpu.parallel import sharding as jshd
from container_engine_accelerators_tpu.training import train as jtrain
from container_engine_accelerators_tpu_torch.ops import quant as tquant
from container_engine_accelerators_tpu_torch.parallel import grad_comm as tgc
from container_engine_accelerators_tpu_torch.parallel import launch
from container_engine_accelerators_tpu_torch.parallel import mesh as tmesh
from container_engine_accelerators_tpu_torch.training import data as tdata
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"PYTHONPATH": os.pathsep.join([REPO,
                                           os.path.join(REPO, "tests")])}
GRAD_TOL = 1e-5


def _leaves(*sizes):
    return [jax.ShapeDtypeStruct((n,), jnp.float32) for n in sizes]


@pytest.mark.parametrize("sizes,target", [
    ((10, 300, 7, 1024, 64, 1), 1200), ((10, 300, 7, 1024, 64, 1), 64),
    ((4096,), 1 << 20), ((100000, 3, 5), 4096), ((1, 1, 1, 1), 8),
    ((64, 64, 64, 64, 64), 512)])
def test_partition_buckets_equal_jax(sizes, target):
    leaves = _leaves(*sizes)
    got = tgc.partition_buckets(leaves, target)
    assert got == jgc.partition_buckets(leaves, target)
    assert sorted(i for b in got for i in b) == list(range(len(sizes)))
    assert got == tgc.partition_buckets(leaves, target)   # deterministic
    assert got[0][0] == len(sizes) - 1                    # lm_head first


@pytest.mark.parametrize("shapes", [[(4096,), (4096,)], [(8, 16), (3,)],
                                    [(2, 5, 7)]])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("compress", ["none", "int8"])
def test_wire_bytes_equal_jax(shapes, n, compress):
    leaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    assert tgc.wire_bytes(leaves, n, compress) == jgc.wire_bytes(
        leaves, n, compress)
    for lf in leaves:
        assert tgc.leaf_wire_bytes(lf, n, compress) == jgc.leaf_wire_bytes(
            lf, n, compress)


def test_config_rejects_unknown_modes():
    with pytest.raises(ValueError, match="compress"):
        tgc.DcnOverlapConfig(compress="fp8")
    with pytest.raises(ValueError, match="positive"):
        tgc.DcnOverlapConfig(bucket_bytes=0)


@pytest.mark.parametrize("shape", [(), (64,), (4, 64), (2, 8, 16),
                                   (2, 3, 4, 5)])
def test_quantize_grads_equal_jax(shape):
    g = np.asarray(np.random.default_rng(len(shape)).normal(
        size=shape) * 1e-3, dtype=np.float32)
    jq, js = jquant.quantize_grads(jnp.asarray(g))
    tq, ts = tquant.quantize_grads(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.shape == js.shape
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    np.testing.assert_allclose(
        tquant.dequantize_grads(tq, ts, scale=0.25).numpy(),
        np.asarray(jquant.dequantize_grads(jq, js, scale=0.25)), rtol=1e-6)


def test_error_feedback_cancels_quantization_bias():
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 32)).astype(np.float32))
    ef = torch.zeros_like(g)
    applied = torch.zeros_like(g)
    one_step_err = None
    for t in range(32):
        c = g + ef
        q, s = tquant.quantize_grads(c)
        out = tquant.dequantize_grads(q, s)
        ef = c - out
        applied += out
        if t == 0:
            one_step_err = float((out - g).abs().max())
    mean_err = float((applied / 32 - g).abs().max())
    assert mean_err < one_step_err / 4, (mean_err, one_step_err)


def _port_mesh(**axes):
    m = tmesh.single_mesh("cpu")
    m.axes = tmesh.MeshAxes(**axes)
    return m


def test_validate_mesh_for_overlap_messages_equal_jax(cpu_devices):
    cfg = tgc.DcnOverlapConfig(bucket_bytes=1 << 16)
    jcfg = jgc.DcnOverlapConfig(bucket_bytes=1 << 16)
    tgc.validate_mesh_for_overlap(_port_mesh(dp=2, fsdp=2), cfg)
    for axes in (dict(fsdp=2, sp=4), dict(pp=2, dp=2, fsdp=2),
                 dict(dp=2, ep=4)):
        jm = jmesh.make_mesh(jmesh.MeshAxes(**axes), devices=cpu_devices)
        with pytest.raises(ValueError) as want:
            jgc.validate_mesh_for_overlap(jm, jcfg)
        with pytest.raises(ValueError) as got:
            tgc.validate_mesh_for_overlap(_port_mesh(**axes), cfg)
        assert str(got.value).split(" (mesh")[0] == \
            str(want.value).split(" (mesh")[0]
    with pytest.raises(ValueError, match="sequence_parallel"):
        tgc.validate_mesh_for_overlap(_port_mesh(dp=2), cfg,
                                      sequence_parallel=True)


CFG = dict(vocab_size=64)
BATCH, SEQ = 8, 32


def _batch(seed=0):
    b = next(tdata.synthetic_batches(64, BATCH, SEQ, seed=seed))
    b["targets"][1, :20] = -1        # ranks see different token counts
    b["targets"][6, :5] = -1
    return b


def _jax_reduced(tree, batch, dcn, ga, devices):
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **CFG)
    mesh = jmesh.make_mesh(jmesh.MeshAxes(dp=2, fsdp=2), devices=devices[:4])
    params = jax.device_put(tree, jshd.param_shardings(mesh))
    stacked_fn = jtrain._make_overlap_grads(jcfg, mesh, dcn, ga)
    specs = jshd.llama_param_specs()
    reducer = jgc.make_bucket_reducer(mesh, params, specs, dcn,
                                      denom=2 * ga)
    ef = jgc.init_error_feedback(mesh, params, specs, dcn)
    ef_leaves = None if ef is None else jax.tree_util.tree_flatten(ef)[0]

    def full(p, b):
        _, stacked = stacked_fn(p, b)
        return reducer.reduce(stacked, ef_leaves)[0], stacked

    grads, stacked = jax.jit(full)(params, jtrain.shard_batch(batch, mesh))
    treedef = jax.tree_util.tree_structure(params)
    # One int8 step of each leaf: its largest slot's absmax / 127, over
    # the mean's denominator.
    steps = [float(jnp.abs(x).max()) / 127.0 / (2 * ga) for x in stacked]
    return jax.device_get((jax.tree_util.tree_unflatten(treedef, grads),
                           jax.tree_util.tree_unflatten(treedef, steps)))


def _flat_jax(tree, n_layers):
    """{port parameter name: value} of a JAX param tree; a scalar stands
    for every layer of its stack."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "lm_head": tree["lm_head"]}
    for name, stacked in tree["layers"].items():
        for i in range(n_layers):
            out[f"layers.{i}.{name}"] = (stacked if np.ndim(stacked) == 0
                                         else stacked[i])
    return out


def test_reduced_grads_of_four_ranks_equal_jax_overlap(cpu_devices,
                                                       two_torch_threads):
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **CFG)
    tree = jax.device_get(jllama.init_params(jax.random.key(0), jcfg))
    batch = _batch()
    modes = [("none", 1), ("none", 2), ("int8", 1)]
    cases = [dict(axes=dict(dp=2, fsdp=2), cfg=CFG, tree=tree,
                  batches=[batch], grad_accum=ga, grads_only=True,
                  opt=dict(lr=1e-4),
                  dcn=dict(bucket_bytes=1 << 14, compress=c))
             for c, ga in modes]
    got = launch.run_ranks("torch_dist_cases:train_steps", 4,
                           {"cases": cases}, env=RANK_ENV, cwd=REPO,
                           timeout=240)[0]
    for (compress, ga), res in zip(modes, got):
        dcn = jgc.DcnOverlapConfig(bucket_bytes=1 << 14, compress=compress)
        grads, steps = _jax_reduced(tree, batch, dcn, ga, cpu_devices)
        want = _flat_jax(grads, jcfg.n_layers)
        steps = _flat_jax(steps, jcfg.n_layers)
        assert set(res["grads"]) == set(want)
        for name, w in want.items():
            w = np.asarray(w, np.float32)
            diff = np.abs(res["grads"][name] - w)
            bound = GRAD_TOL * np.abs(w).max()
            if compress == "none":
                assert diff.max() <= bound, (compress, ga, name)
                continue
            step = steps[name] * 1.01 + bound
            assert diff.max() <= step, (name, diff.max(), step)
            assert (diff > bound).mean() <= 1e-3, name


def test_dropped_overlap_step_frees_its_model():
    """A train step over the bucketed reducer, dropped without detaching
    its hooks, frees the model it reduced: a parameter's hooks reach
    the reducer only weakly (the garbage collector does not follow
    them), and the hooks left behind do nothing on later backwards."""
    import gc
    import weakref

    from container_engine_accelerators_tpu_torch.models import llama
    from container_engine_accelerators_tpu_torch.training import train

    cfg = llama.llama_tiny(n_layers=1, vocab_size=64, use_flash=False)
    state = train.create_train_state(cfg, train.make_optimizer(),
                                     device="cpu")
    step = train.make_train_step(
        cfg, state.optimizer, mesh=tmesh.single_mesh("cpu"),
        dcn_overlap=tgc.DcnOverlapConfig(bucket_bytes=1 << 16),
        state=state)
    step(state.model, train.to_device(_batch(), torch.device("cpu")))
    reducer = weakref.ref(step.reducer)
    weight = weakref.ref(state.model.embed)
    del step
    gc.collect()
    assert reducer() is None
    loss = train.loss_fn(state.model, train.to_device(
        _batch(1), torch.device("cpu")), cfg)
    loss.backward()          # the orphaned hooks fire and do nothing
    del state, loss
    gc.collect()
    assert weight() is None
