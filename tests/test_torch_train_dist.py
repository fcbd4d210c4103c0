"""Port of training/train.py across ranks, held against the JAX package
on the CPU: three steps of make_train_step on the same mesh shape in
both packages (gloo rank processes against a mesh of virtual CPU
devices), from the same interop parameters and batches: fsdp 2, fsdp 2
at grad_accum 2, sp 2 ring and Ulysses, a mixture of experts (capacity
routing, ep 1) at fsdp 2, and dp 2 x fsdp 2. Each step's loss and grad
norm within 1e-5 relative, the tokens exactly, and the gathered params
after the third step within 1e-5 of each weight's largest |p| (f32 both
sides; tests/test_torch_train.py's tolerances and AdamW eps). Rows
carry masked targets, so the ranks hold different token counts. tp > 1,
pp > 1 and ep > 1 raise naming the item they wait for."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu.parallel import mesh as jmesh
from container_engine_accelerators_tpu.parallel import sharding as jshd
from container_engine_accelerators_tpu.training import train as jtrain
from container_engine_accelerators_tpu.training.fused_adamw import (
    fused_adamw,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.parallel import launch
from container_engine_accelerators_tpu_torch.parallel import mesh as tmesh
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import train as ttrain
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"PYTHONPATH": os.pathsep.join([REPO,
                                           os.path.join(REPO, "tests")])}
LOSS_RTOL, PARAM_TOL = 1e-5, 1e-5
OPT = dict(b1=0.9, b2=0.95, eps=1e-5, weight_decay=0.1, grad_clip=1.0)
LR = 1e-4
B, S, STEPS = 4, 64, 3
MOE = dict(n_experts=4, moe_top_k=2)

CASES = {
    "fsdp2": dict(axes=dict(fsdp=2), cfg={}),
    "fsdp2_ga2": dict(axes=dict(fsdp=2), cfg={}, grad_accum=2),
    "sp2_ring": dict(axes=dict(sp=2), cfg=dict(sequence_parallel=True)),
    "sp2_ulysses": dict(axes=dict(sp=2), cfg=dict(
        sequence_parallel=True, sequence_parallel_mode="ulysses")),
    "moe_fsdp2": dict(axes=dict(fsdp=2), cfg=MOE),
    "dp2_fsdp2": dict(axes=dict(dp=2, fsdp=2), cfg={}),
}


def _batches():
    out = list(tdata.synthetic_batches(512, B, S, num_batches=STEPS,
                                       seed=1))
    for i, b in enumerate(out):
        b["targets"][i % B, :S // 3] = -1
        b["targets"][(i + 2) % B, -5:] = -1
    return out


def _jax_run(case, tree, batches, devices):
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **case["cfg"])
    axes = jmesh.MeshAxes(**case["axes"])
    mesh = jmesh.make_mesh(axes, devices=devices[:axes.total])
    moe = bool(jcfg.n_experts)
    params = jax.device_put(tree, jshd.param_shardings(mesh, moe=moe))
    opt = fused_adamw(LR, **OPT)
    repl = NamedSharding(mesh, P())
    opt_state = jax.tree.map(lambda x: jax.device_put(x, repl)
                             if np.ndim(x) == 0 else x,
                             jax.jit(opt.init)(params))
    state = jtrain.TrainState(jax.device_put(jnp.zeros((), jnp.int32), repl),
                              params, opt_state)
    step = jtrain.make_train_step(jcfg, mesh, opt,
                                  grad_accum=case.get("grad_accum", 1))
    losses, norms, tokens = [], [], []
    for b in batches:
        state, m = step(state, jtrain.shard_batch(
            b, mesh, bool(jcfg.sequence_parallel)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        tokens.append(int(m["tokens"]))
    return losses, norms, tokens, jax.device_get(state.params)


def _flat(tree, n_layers):
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "lm_head": tree["lm_head"]}
    for name, stacked in tree["layers"].items():
        for i in range(n_layers):
            out[f"layers.{i}.{name}"] = stacked[i]
    return out


def _port_cases(names, tree_of, batches):
    return [dict(CASES[n], tree=tree_of(n), batches=batches,
                 opt=dict(lr=LR, **OPT)) for n in names]


@pytest.mark.parametrize("names,world", [
    (("fsdp2", "fsdp2_ga2", "sp2_ring", "sp2_ulysses", "moe_fsdp2"), 2),
    (("dp2_fsdp2",), 4)])
def test_train_steps_equal_jax(cpu_devices, names, world,
                               two_torch_threads):
    batches = _batches()
    trees = {}

    def tree_of(name):
        jcfg = jllama.llama_tiny(dtype=jnp.float32, **CASES[name]["cfg"])
        key = bool(jcfg.n_experts)
        if key not in trees:
            trees[key] = jax.device_get(jllama.init_params(
                jax.random.key(0), jcfg))
        return trees[key]

    got = launch.run_ranks("torch_dist_cases:train_steps", world,
                           {"cases": _port_cases(names, tree_of, batches)},
                           env=RANK_ENV, cwd=REPO, timeout=300)[0]
    for name, res in zip(names, got):
        losses, norms, tokens, params = _jax_run(
            CASES[name], tree_of(name), batches, cpu_devices)
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(res["grad_norms"], norms, rtol=1e-5,
                                   err_msg=name)
        assert res["tokens"] == tokens, name
        n_layers = params["layers"]["wq"].shape[0]
        for key, want in _flat(params, n_layers).items():
            want = np.asarray(want, np.float32)
            err = np.abs(res["params"][key] - want).max()
            assert err <= PARAM_TOL * np.abs(want).max(), (name, key, err)


def _fake_mesh(**axes):
    m = tmesh.single_mesh("cpu")
    m.axes = tmesh.MeshAxes(**axes)
    return m


@pytest.mark.parametrize("axes,match", [
    (dict(tp=2), "tp > 1.*ROADMAP item 12"),
    (dict(pp=2), "pp > 1.*ROADMAP item 12"),
    (dict(ep=2), "ep > 1.*ROADMAP item 12")])
def test_unported_axes_raise_naming_their_item(axes, match):
    cfg = tllama.llama_tiny(n_experts=4) if "ep" in axes \
        else tllama.llama_tiny()
    with pytest.raises(NotImplementedError, match=match):
        ttrain.check_train_mesh(cfg, _fake_mesh(**axes))


def test_sp_mesh_needs_sequence_parallel_and_ring_refuses_tri():
    with pytest.raises(ValueError, match="sequence_parallel"):
        ttrain.check_train_mesh(tllama.llama_tiny(), _fake_mesh(sp=2))
    cfg = tllama.llama_tiny(sequence_parallel=True,
                            sequence_parallel_mode="ulysses", n_kv_heads=1)
    with pytest.raises(ValueError, match="ulysses needs n_kv_heads"):
        ttrain.check_train_mesh(cfg, _fake_mesh(sp=2))
    jcfg = jllama.llama_tiny(sequence_parallel=True,
                             flash_causal_grid="tri")
    tcfg = tllama.llama_tiny(sequence_parallel=True,
                             flash_causal_grid="tri")
    with pytest.raises(ValueError) as want:
        jllama.forward(jllama.init_params(jax.random.key(0), jcfg),
                       jnp.zeros((1, 8), jnp.int32), jcfg)
    with pytest.raises(ValueError) as got:
        tllama._check_train_config(tcfg)
    assert str(got.value) == str(want.value)


def test_shard_batch_takes_the_jax_blocks(cpu_devices):
    """Each rank's rows (and sp columns) of a global batch, per
    microbatch: the block of the JAX batch sharding's device r."""
    batch = {"inputs": np.arange(8 * 16).reshape(8, 16).astype(np.int32)}
    for axes, sp, ga in ((dict(dp=2, fsdp=2), False, 1),
                         (dict(dp=2, fsdp=2), False, 2),
                         (dict(fsdp=2, sp=2), True, 1)):
        a = jmesh.MeshAxes(**axes)
        jm = jmesh.make_mesh(a, devices=cpu_devices[:a.total])
        coords = tmesh.coordinates(tmesh.MeshAxes(**axes))
        m = _fake_mesh(**axes)
        for r, coord in enumerate(coords):
            m.coord = coord
            got = ttrain.shard_batch(batch, m, ga, sp)["inputs"]
            micro = batch["inputs"].reshape(ga, -1, 16)
            want = np.concatenate([
                _jax_block(mb, jm, sp, jm.devices.flat[0].id + r,
                           cpu_devices) for mb in micro])
            np.testing.assert_array_equal(got, want)


def _jax_block(x, mesh, sp, device_id, devices):
    arr = jax.device_put(x, NamedSharding(mesh, jshd.batch_spec(sp)))
    for shard in arr.addressable_shards:
        if shard.device.id == device_id:
            return np.asarray(shard.data)
    raise AssertionError(device_id)
