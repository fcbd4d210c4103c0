"""Port of parallel/mesh.py, sharding.py and the rest of distributed.py,
held against the JAX package on the CPU: the axis factorisation and the
slice layout over a grid of counts, each rank's mesh coordinate and
groups (gloo rank processes) against the JAX make_mesh's device layout,
the parameter specs and batch spec as tuples, the coordinator's address
parse, slice count and bounded timeout, and shard_param / GatherShard
round trips with GatherShard's backward against a reduce-scatter done
by hand. Exact: these are integers and copies."""

import itertools
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from container_engine_accelerators_tpu.parallel import distributed as jdist
from container_engine_accelerators_tpu.parallel import mesh as jmesh
from container_engine_accelerators_tpu.parallel import sharding as jshd
from container_engine_accelerators_tpu_torch.parallel import (
    distributed as tdist,
)
from container_engine_accelerators_tpu_torch.parallel import launch
from container_engine_accelerators_tpu_torch.parallel import mesh as tmesh
from container_engine_accelerators_tpu_torch.parallel import (
    sharding as tshd,
)
from container_engine_accelerators_tpu_torch.parallel import spmd_util

from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"PYTHONPATH": os.pathsep.join([REPO,
                                           os.path.join(REPO, "tests")])}


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 32])
@pytest.mark.parametrize("kw", [{}, {"tp": 1}, {"tp": 2, "sp": 2},
                                {"pp": 2}, {"ep": 2, "tp": 1}])
def test_auto_axis_sizes_equal_jax(n, kw):
    try:
        want = jmesh.auto_axis_sizes(n, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tmesh.auto_axis_sizes(n, **kw)
        return
    got = tmesh.auto_axis_sizes(n, **kw)
    assert got.as_tuple() == want.as_tuple()
    assert got.total == want.total == n


AXES = [dict(dp=2, fsdp=2), dict(dp=4, fsdp=2), dict(pp=2, dp=2, fsdp=2),
        dict(dp=2, sp=2, tp=2), dict(fsdp=2, sp=4), dict(dp=8)]


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("slices", [1, 2])
def test_slice_device_array_equals_jax(axes, slices):
    a = jmesh.MeshAxes(**axes)
    ids = list(range(a.total))
    if a.dp % slices:
        with pytest.raises(ValueError, match="multiple of dcn_slices"):
            tmesh.slice_device_array(ids, tmesh.MeshAxes(**axes), slices)
        return
    want = jmesh.slice_device_array(ids, a, slices)
    got = tmesh.slice_device_array(ids, tmesh.MeshAxes(**axes), slices)
    np.testing.assert_array_equal(got.astype(int), want.astype(int))


def _jax_coords(axes: dict, devices, slices=None):
    m = jmesh.make_mesh(jmesh.MeshAxes(**axes), devices=devices,
                        dcn_slices=slices)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    first = min(d.id for d in devices)
    return [dict(zip(jmesh.AXIS_NAMES,
                     (int(c) for c in np.argwhere(ids == first + r)[0])))
            for r in range(ids.size)]


@pytest.mark.parametrize("axes,slices", [(dict(dp=2, fsdp=4), None),
                                         (dict(dp=4, fsdp=2), 2),
                                         (dict(pp=2, dp=2, fsdp=2), 2),
                                         (dict(fsdp=2, sp=2, tp=2), None)])
def test_rank_coordinates_equal_jax_make_mesh(cpu_devices, axes, slices):
    assert tmesh.coordinates(tmesh.MeshAxes(**axes), slices) == \
        _jax_coords(axes, cpu_devices, slices)


def test_gloo_ranks_hold_the_jax_mesh_positions(cpu_devices,
                                                two_torch_threads):
    """Four rank processes build meshes; each rank's coordinate is the
    JAX mesh position of device r, and its group along each axis is the
    ranks that share every other coordinate. GatherShard over fsdp 4:
    forward equal to the whole tensor, backward equal to the sum over
    ranks done by hand, both dims."""
    cases = [(dict(dp=2, fsdp=2), None), (dict(dp=2, fsdp=2), 2),
             (dict(fsdp=2, sp=2), None), (dict(dp=4), None)]
    ranks = launch.run_ranks("torch_dist_cases:mesh_layout", 4,
                             {"cases": cases}, env=RANK_ENV, cwd=REPO,
                             timeout=120)
    for i, (axes, slices) in enumerate(cases):
        want = _jax_coords(axes, cpu_devices[:4], slices)
        coords = [ranks[r][0][i]["coord"] for r in range(4)]
        assert coords == want
        for r in range(4):
            for name, group in ranks[r][0][i]["groups"].items():
                peers = [q for q in range(4)
                         if all(coords[q][a] == coords[r][a]
                                for a in tmesh.AXIS_NAMES if a != name)]
                assert group == (peers if len(peers) > 1 else None), \
                    (axes, r, name)
    for r in range(4):
        for spec, res in ranks[r][1].items():
            assert res == {"forward_equal": True, "grad_equal": True,
                           "full_equal": True}, (r, spec)


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in tree)


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("moe", [False, True])
def test_llama_param_specs_equal_jax(pipeline, moe):
    assert tshd.llama_param_specs(pipeline, moe) == _as_tuples(
        jshd.llama_param_specs(pipeline=pipeline, moe=moe))


@pytest.mark.parametrize("sp", [False, True])
def test_batch_and_activation_specs_equal_jax(sp):
    assert tshd.batch_spec(sp) == tuple(jshd.batch_spec(sp))
    for kind, spec in jshd._ACTIVATION_SPECS.items():
        assert tshd.ACTIVATION_SPECS[kind](sp) == tuple(spec(sp)), kind
    x = object()
    assert tshd.make_constrain(None, sp)(x, "resid") is x


def test_param_spec_drops_the_layer_axis():
    assert tshd.param_spec("layers.3.wq") == ("fsdp", "tp")
    assert tshd.param_spec("layers.0.w_down", moe=True) == (
        "ep", "tp", "fsdp")
    assert tshd.param_spec("embed") == ("tp", "fsdp")
    assert tshd.param_spec("final_norm") == (None,)


def test_shard_param_blocks_round_trip():
    m = tmesh.single_mesh("cpu")
    full = np.arange(24).reshape(4, 6)
    assert tshd.shard_param(full, ("fsdp", None), m) is full
    for i, j in itertools.product(range(2), range(3)):
        m.axes = tmesh.MeshAxes(dp=3, fsdp=2)
        m.coord = dict(m.coord, fsdp=i, dp=j)
        block = tshd.shard_param(full, (None, "fsdp"), m)
        np.testing.assert_array_equal(block, full[:, 3 * i:3 * i + 3])
        rows = spmd_util.local_rows(np.arange(12), m)
        np.testing.assert_array_equal(rows, np.arange(12)[
            2 * (j * 2 + i):2 * (j * 2 + i) + 2])
    with pytest.raises(ValueError, match="does not split"):
        tshd.shard_param(np.zeros((3, 3)), ("fsdp", None), m)


def test_split_host_port_equals_jax():
    for addr in ("coord", "coord:1234", "10.0.0.1:8476", "::1",
                 "fe80::1:2:3", "[::1]", "[::1]:9999"):
        assert tdist.split_host_port(addr) == jdist.split_host_port(addr)
    assert tdist.split_host_port("host", default_port="9") == ("host", "9")


def test_num_slices_and_timeout_env_contract(monkeypatch):
    for var in ("MEGASCALE_NUM_SLICES", "JAX_NUM_SLICES",
                "JAX_COORDINATOR_TIMEOUT_S"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.num_slices() == jdist.num_slices() == 1
    monkeypatch.setenv("JAX_NUM_SLICES", "4")
    assert tdist.num_slices() == jdist.num_slices() == 4
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    assert tdist.num_slices() == jdist.num_slices() == 2
    assert tdist.coordinator_timeout_s() == jdist.coordinator_timeout_s()
    monkeypatch.setenv("JAX_COORDINATOR_TIMEOUT_S", "nope")
    assert tdist.coordinator_timeout_s() == 300.0


def test_initialize_inactive_without_env(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.env_rendezvous() is None


def test_coordinator_timeout_is_bounded_and_structured():
    """A coordinator that is gone: the rank fails with
    CoordinatorConnectError naming the address and rank within the
    env's bound, as the JAX package's (tests/test_multislice.py)."""
    port = launch.free_port()
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES="2", JAX_PROCESS_ID="1",
               JAX_COORDINATOR_TIMEOUT_S="3", PYTHONPATH=REPO)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(var, None)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-c",
         "from container_engine_accelerators_tpu_torch.parallel.distributed"
         " import initialize_from_env; initialize_from_env(None, 'cpu')"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t0
    assert out.returncode != 0
    assert "CoordinatorConnectError" in out.stderr
    assert f"127.0.0.1:{port}" in out.stderr
    assert "process 1/2" in out.stderr
    assert wall < 60, f"timeout path took {wall:.0f}s"


def test_placement_rule_names_the_card():
    assert tdist.placement(3, "cpu") == ("gloo", [tdist.torch.device(
        "cpu")] * 3)
    with pytest.raises(ValueError):
        tdist.placement(0, "cpu")


def _cuda(i):
    return tdist.torch.device("cuda", i)


def test_placement_reads_each_hosts_own_view():
    """A job across hosts: each rank takes the card of its index on its
    own host, never the global rank's; ranks stacked past a host's
    cards share cuda:0 over gloo on one host only."""
    two_by_eight = [(f"h{r // 8}", 8) for r in range(16)]
    assert tdist.choose_placement(two_by_eight, 9) == ("nccl", _cuda(1))
    assert tdist.choose_placement(two_by_eight, 0) == ("nccl", _cuda(0))
    # Hosts in any rank order: the index among the host's own ranks.
    mixed = [("a", 2), ("b", 2), ("a", 2), ("b", 2)]
    assert [tdist.choose_placement(mixed, r)[1] for r in range(4)] == [
        _cuda(0), _cuda(0), _cuda(1), _cuda(1)]
    one_host = [("h", 1)] * 2
    assert tdist.choose_placement(one_host, 1) == ("gloo", _cuda(0))
    assert tdist.choose_placement(one_host, 1, "cpu") == (
        "gloo", tdist.torch.device("cpu"))


def test_placement_refuses_stacking_ranks_across_hosts():
    """torchrun on 2 nodes x 8 ranks with one card a node: refused,
    naming the host and the launch to use, not staged through cuda:0."""
    hosts = [(f"h{r // 8}", 1) for r in range(16)]
    for rank in (0, 9):
        with pytest.raises(RuntimeError, match=r"host 'h0' runs 8 ranks "
                           r"of a 16-rank job across 2 hosts.*"
                           r"--nproc-per-node 1"):
            tdist.choose_placement(hosts, rank)


def test_torchrun_hosts_from_local_world_size(monkeypatch):
    monkeypatch.setattr(tdist.torch.cuda, "device_count", lambda: 8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert tdist.torchrun_hosts(16) is None
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    hosts = tdist.torchrun_hosts(16)
    assert hosts == [(str(r // 8), 8) for r in range(16)]
    assert tdist.choose_placement(hosts, 9) == ("nccl", _cuda(1))


def test_hosts_exchanged_through_the_store(monkeypatch):
    """Each rank posts its host and cards to the store and reads every
    rank's back in rank order (threads stand in for the ranks)."""
    import socket
    import threading

    monkeypatch.setattr(socket, "gethostname", lambda: "node-a")
    monkeypatch.setattr(tdist.torch.cuda, "device_count", lambda: 4)
    store = tdist.dist.HashStore()
    got = [None] * 3

    def rank(r):
        got[r] = tdist.exchange_hosts(store, r, 3)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert got == [[("node-a", 4)] * 3] * 3
