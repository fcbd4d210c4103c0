"""Port of parallel/ring_attention.py and parallel/ulysses.py, held
against the JAX package on the CPU: 2 and 4 gloo rank processes, each
holding one chunk of the sequence, against the JAX ring_attention and
ulysses_attention on sp meshes of the same size (virtual CPU devices).
The output and the q/k/v gradients of sum(out * w), causal and not, in
f32, within 1e-5 of each array's largest magnitude (both sides sum the
chunks in other orders). The ring's all_to_all hop form (what gloo on
CUDA tensors takes) is held on the CPU too, and the divisibility errors
against the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from container_engine_accelerators_tpu.parallel import mesh as jmesh
from container_engine_accelerators_tpu.parallel import ring_attention as jra
from container_engine_accelerators_tpu.parallel import ulysses as jul
from container_engine_accelerators_tpu_torch.parallel import launch
from container_engine_accelerators_tpu_torch.parallel import ulysses as tul
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"PYTHONPATH": os.pathsep.join([REPO,
                                           os.path.join(REPO, "tests")])}
RTOL = 1e-5     # of each array's largest |value|
B, S, D = 2, 64, 16


def _inputs(seed, hq, hkv):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((B, S, hq, D), dtype=np.float32),
            "k": rng.standard_normal((B, S, hkv, D), dtype=np.float32),
            "v": rng.standard_normal((B, S, hkv, D), dtype=np.float32),
            "w": rng.standard_normal((B, S, hq, D), dtype=np.float32)}


def _jax(mode, causal, n, x, devices):
    mesh = jmesh.make_mesh(jmesh.MeshAxes(sp=n), devices=devices[:n])

    def f(q, k, v):
        if mode == "ring":
            out = jra.ring_attention(q, k, v, axis_name="sp", causal=causal,
                                     mesh=mesh)
        else:
            out = jul.ulysses_attention(q, k, v, axis_name="sp",
                                        causal=causal, mesh=mesh)
        return jnp.sum(out * x["w"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return {"out": out, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


CASES = [("ring", True, None), ("ring", False, None),
         ("ring", True, "all_to_all"), ("ulysses", True, None),
         ("ulysses", False, None)]


@pytest.mark.parametrize("n", [2, 4])
def test_sp_attention_equals_jax(cpu_devices, n, two_torch_threads):
    cases = []
    for i, (mode, causal, form) in enumerate(CASES):
        x = _inputs(i, 8, 4)
        cases.append(dict(x, mode=mode, causal=causal, form=form))
    got = launch.run_ranks("torch_dist_cases:attention", n,
                           {"cases": cases}, env=RANK_ENV, cwd=REPO,
                           timeout=180)[0]
    for case, res in zip(cases, got):
        want = _jax(case["mode"], case["causal"], n, case, cpu_devices)
        for key, w in want.items():
            w = np.asarray(w)
            err = np.abs(res[key] - w).max()
            assert err <= RTOL * np.abs(w).max(), (
                case["mode"], case["causal"], case["form"], key, err)


@pytest.mark.parametrize("hq,hkv,sp", [(6, 2, 4), (8, 2, 4), (4, 4, 8)])
def test_ulysses_divisibility_errors_equal_jax(cpu_devices, hq, hkv, sp):
    mesh = jmesh.make_mesh(jmesh.MeshAxes(sp=sp), devices=cpu_devices[:sp])
    q = jnp.zeros((1, 16 * sp, hq, 8))
    k = jnp.zeros((1, 16 * sp, hkv, 8))
    with pytest.raises(ValueError) as want:
        jul.ulysses_attention(q, k, k, mesh=mesh)
    with pytest.raises(ValueError) as got:
        tul.check_heads(hq, hkv, sp)
    assert str(got.value) == str(want.value)
