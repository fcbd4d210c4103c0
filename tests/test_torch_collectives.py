"""The port's collective probes (ops/collectives.py) and collective_bench
(cli/collective_bench.py) held against the JAX package's on the CPU.

The accounting (nccl-tests' bus factors, each probe's reported size) and
the report's text must equal JAX's for every collective and n from 1 to
8. Four gloo ranks, each a process of its own, run the five probes on
shards of one seeded numpy array of small integers; each rank's result
must equal the matching part of JAX's on a 4-device sub-mesh of the
conftest's 8 CPU devices, exactly (f32 sums of small integers are exact
in any order). collective_bench runs as one gloo rank with JAX's JSON
keys, and as two processes (marked slow, as JAX's two-process case is).
Tolerance: exact throughout."""

import json
import os
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from container_engine_accelerators_tpu.cli import collective_bench as jbench
from container_engine_accelerators_tpu.ops import collectives as jcoll
from container_engine_accelerators_tpu_torch.cli import (
    collective_bench as tbench,
)
from container_engine_accelerators_tpu_torch.ops import collectives as tcoll
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401

SEED = 17
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, ELEMS = 4, 64           # the gloo ranks and each one's shard


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_gloo():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _identity(x):
    return x


@pytest.mark.parametrize("size", [1 << 10, 3000, 1 << 16])
def test_bus_factors_and_reported_sizes_equal_jax(cpu_devices, one_rank_gloo,
                                                  size):
    """Each probe's reported size and busBW/algBW for n = 1..8 (the
    collective itself replaced by the identity in both packages: the
    accounting is what is held here)."""
    assert tcoll.COLLECTIVES == jcoll.COLLECTIVES
    for n in range(1, 9):
        mesh = Mesh(np.array(cpu_devices[:n]), ("dp",))
        for c in tcoll.COLLECTIVES:
            assert tcoll._BUS_FACTORS[c](n) == jcoll._BUS_FACTORS[c](n)
            want = jcoll.probe_collective(mesh, "dp", c, size, warmup=0,
                                          iters=1, prebuilt=(_identity, n))
            got = tcoll.probe_collective(one_rank_gloo, "dp", c, size,
                                         warmup=0, iters=1,
                                         prebuilt=(_identity, n))
            assert got.size_bytes == want.size_bytes, (c, n)
            assert got.collective == want.collective
            assert got.bus_bw_gbps / got.alg_bw_gbps == pytest.approx(
                want.bus_bw_gbps / want.alg_bw_gbps, abs=1e-12), (c, n)


def test_report_text_equals_jax():
    rs = np.random.RandomState(SEED)
    rows = [(c, int(rs.randint(1, 1 << 30)), float(rs.uniform(1, 1e4)),
             float(rs.uniform(0, 500)), float(rs.uniform(0, 500)))
            for c in tcoll.COLLECTIVES for _ in range(3)]
    assert tcoll.report([tcoll.CollectiveResult(*r) for r in rows]) == \
        jcoll.report([jcoll.CollectiveResult(*r) for r in rows])
    assert tcoll.report([]) == jcoll.report([])


@pytest.mark.parametrize("argv", [
    [], ["--collective", "all", "-b", "1M", "-e", "512M", "-f", "2", "-w",
         "5", "--iters", "20", "--json"],
    ["--collective", "all_reduce,ppermute", "-b", "16k", "-e", "2G",
     "--axis", "dcn", "--coordinator", "10.0.0.1:8476",
     "--num-processes", "2", "--process-id", "1", "--backend", "gloo"]])
def test_parse_args_equal_jax(argv):
    """Every flag parses as JAX's does; --backend names a torch backend
    and defaults to nccl where JAX's names a jax platform (default
    none)."""
    got, want = vars(tbench.parse_args(argv)), vars(jbench.parse_args(argv))
    if "--backend" not in argv:
        assert (got.pop("backend"), want.pop("backend")) == ("nccl", None)
    assert got == want
    for text in ("1", "1k", "16K", "1M", "512m", "2G", "0"):
        assert tbench.parse_size(text) == jbench.parse_size(text)
    for bad in ("1.5M", "M", "1T", ""):
        with pytest.raises(Exception):
            tbench.parse_size(bad)


def test_axis_fabric_reads_the_job_at_each_call(monkeypatch):
    """'dcn' only for dp across hosts (WORLD_SIZE over LOCAL_WORLD_SIZE),
    read when called, as JAX's reads process_count at each call."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert [tcoll.axis_fabric(a) for a in ("dp", "tp")] == ["ici", "ici"]
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert [tcoll.axis_fabric(a) for a in ("dp", "tp")] == ["dcn", "ici"]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "16")
    assert tcoll.axis_fabric("dp") == "ici"


# One gloo rank: argv rank, world, port, input .npy, output .json.
RANK_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from container_engine_accelerators_tpu_torch.ops import collectives
rank, world, port = (int(a) for a in sys.argv[1:4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
x = np.load(sys.argv[4])
elems = x.size // world
shard = torch.from_numpy(x[rank * elems:(rank + 1) * elems].copy())
out = {}
for name in collectives.COLLECTIVES:
    fn, n = collectives.build_probe(dist.group.WORLD, "dp", name)
    out[name] = fn(shard.clone()).tolist()
r = collectives.probe_collective(dist.group.WORLD, "dp", "ppermute", 1024,
                                 warmup=1, iters=2)
out["_probe"] = [r.size_bytes, r.bus_bw_gbps > 0]
dist.destroy_process_group()
with open(sys.argv[5], "w") as f:
    json.dump(out, f)
"""


def _run_ranks(code: str, world: int, *extra, timeout: float = 120,
               env=None) -> list:
    """`code` in `world` processes (argv rank, world, port, *extra, an
    output path); each one's JSON output."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), str(port),
             *extra, outs[r]], cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                     **(env or {}))) for r in range(world)]
        try:
            errs = [p.communicate(timeout=timeout)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
        for p, err in zip(procs, errs):
            assert p.returncode == 0, err[-2000:]
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results


def test_four_gloo_ranks_equal_jax_on_a_four_device_mesh(cpu_devices,
                                                         tmp_path,
                                                         two_torch_threads):
    x = np.random.RandomState(SEED).randint(
        -8, 8, size=RANKS * ELEMS).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    ranks = _run_ranks(RANK_WORKER, RANKS, str(path))
    mesh = Mesh(np.array(cpu_devices[:RANKS]), ("dp",))
    for name in tcoll.COLLECTIVES:
        mapped, n = jcoll.build_probe(mesh, "dp", name)
        want = np.asarray(mapped(jax.device_put(
            jnp.asarray(x), jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("dp")))))
        if name == "all_gather":        # replicated: the whole array
            parts = [want] * RANKS
        else:                           # sharded: each rank's block
            parts = np.split(want, RANKS)
        for r in range(RANKS):
            np.testing.assert_array_equal(
                np.asarray(ranks[r][name], np.float32), parts[r],
                err_msg=f"{name} rank {r}")
    assert all(r["_probe"] == [1024, True] for r in ranks)


def test_collective_bench_one_gloo_rank_has_jaxs_keys(capsys):
    assert tbench.main(["--backend", "gloo", "--collective", "all", "-b",
                        "1k", "-e", "2k", "-w", "1", "--iters", "2",
                        "--json"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert jbench.main(["--backend", "cpu", "--collective", "all_reduce",
                        "-b", "1k", "-e", "1k", "-w", "1", "--iters", "1",
                        "--json"]) == 0
    jrow = json.loads(capsys.readouterr().out.splitlines()[0])
    assert len(rows) == 2 * len(tcoll.COLLECTIVES)
    assert all(list(r) == list(jrow) for r in rows)
    assert {r["collective"] for r in rows} == set(tcoll.COLLECTIVES)
    assert all(r["devices"] == 1 and r["axis"] == "ici" and r["time_us"] > 0
               for r in rows)
    # n = 1: only ppermute moves bytes.
    assert all((r["bus_bw_gbps"] > 0) == (r["collective"] == "ppermute")
               for r in rows)
    assert not dist.is_initialized()


def test_collective_bench_refuses_nccl_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tbench.main(["-b", "1k", "-e", "1k"])
    assert not dist.is_initialized()


BENCH_RANK = r"""
import sys
from container_engine_accelerators_tpu_torch.cli import collective_bench
rank, world, port = sys.argv[1:4]
import contextlib, io
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = collective_bench.main([
        "--backend", "gloo", "--axis", "dcn", "--collective",
        "all_reduce,all_gather", "-b", "16k", "-e", "32k", "-f", "2",
        "-w", "1", "--iters", "2", "--json", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", world, "--process-id", rank])
with open(sys.argv[4], "w") as f:
    f.write(buf.getvalue())
sys.exit(rc)
"""


@pytest.mark.slow
def test_collective_bench_cli_two_processes(two_torch_threads):
    """collective_bench as two gloo ranks over a TCP rendezvous, the
    counterpart of JAX's two-process case: dcn rows, 2 devices, busBW
    above 0 for all_reduce and all_gather at n = 2."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"r{r}.txt") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", BENCH_RANK, str(r), "2", str(port),
             outs[r]], cwd=REPO, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO)) for r in range(2)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, err[-2000:]
        for path in outs:
            with open(path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            assert len(rows) == 4
            assert all(r["axis"] == "dcn" and r["devices"] == 2
                       and r["bus_bw_gbps"] > 0 for r in rows)
