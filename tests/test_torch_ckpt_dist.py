"""Port of training/checkpoint.py's topology tag, collective save and
reshard, held against the JAX package's contract
(tests/test_multislice.py): the tag's round trip and topology_changed
against the JAX function, a state fit and saved at fsdp 2 by two gloo
rank processes restored in this process at fsdp 1 bit for bit (params
and AdamW moments against the ranks' gathered shards), saved again at
fsdp 1 and restored by two ranks at fsdp 2 bit for bit, the restore
into another topology charged to the recorder's `reshard` bucket, the
in-process single writer, and the rank-0-only quarantine of a torn
step."""

import json
import os

import numpy as np
import pytest

from container_engine_accelerators_tpu.training.checkpoint import (
    topology_changed as jax_topology_changed,
)
from container_engine_accelerators_tpu_torch.metrics.train_metrics import (
    TrainRecorder,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.parallel import launch
from container_engine_accelerators_tpu_torch.parallel import mesh as tmesh
from container_engine_accelerators_tpu_torch.training import checkpoint as ck
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import train as ttrain
from tests.torch_smoke_fixtures import two_torch_threads  # noqa: F401
from tests.torch_dist_cases import gathered_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"PYTHONPATH": os.pathsep.join([REPO,
                                           os.path.join(REPO, "tests")])}
CFG = dict(vocab_size=256)


def test_topology_changed_equals_jax():
    a = {"processes": 2, "devices": 8, "axes": {"dp": 2}}
    for saved, cur in ((a, dict(a, processes=1)), (a, dict(a)), (None, a),
                       (a, None), (a, {"processes": 2}),
                       (a, dict(a, axes={"dp": 1}))):
        assert ck.topology_changed(saved, cur) == jax_topology_changed(
            saved, cur)
    assert ck.current_topology() == {"processes": 1, "devices": 1}
    m = tmesh.single_mesh("cpu")
    assert ck.current_topology(m)["axes"] == m.shape


def _state(cfg, seed=0):
    return ttrain.create_train_state(
        cfg, ttrain.make_optimizer(warmup_steps=2, decay_steps=50),
        mesh=tmesh.single_mesh("cpu"), seed=seed)


def _assert_same(got: dict, want: dict, what: str):
    assert got["count"] == want["count"], what
    for part in ("params", "opt"):
        assert set(got[part]) == set(want[part]), (what, part)
        for key, w in want[part].items():
            np.testing.assert_array_equal(got[part][key], w,
                                          err_msg=f"{what} {key}")


def test_fsdp2_to_fsdp1_to_fsdp2_is_bit_identical(tmp_path,
                                                  two_torch_threads):
    d2, d1 = str(tmp_path / "fsdp2"), str(tmp_path / "fsdp1")
    saved = launch.run_ranks(
        "torch_dist_cases:fit_case", 2,
        dict(ckpt_dir=d2, axes=dict(fsdp=2), steps=2, cfg_kw=CFG),
        env=RANK_ENV, cwd=REPO, timeout=240)[0]
    assert saved["step"] == 2
    assert saved["goodput"]["reshard"] == 0.0
    mngr = ck.CheckpointManager(d2)
    topo = mngr.saved_topology(2)
    assert topo == {"processes": 2, "devices": 2,
                    "axes": dict(tmesh.single_mesh("cpu").shape, fsdp=2)}
    assert sorted(os.listdir(os.path.join(d2, "2", "state"))) == [
        "meta.json", *sorted(ck.shard_files(0, 2) + ck.shard_files(1, 2))]

    cfg = tllama.llama_tiny(**CFG)
    state = _state(cfg, seed=1)
    assert mngr.restore(state) is state and state.step == 2
    assert mngr.last_restore_info["topology_changed"] is True
    assert mngr.last_restore_info["saved_topology"] == topo
    one = gathered_state(state, tmesh.single_mesh("cpu"))
    _assert_same(one, saved, "fsdp 2 -> 1")
    mngr.close()

    out = ck.CheckpointManager(d1)
    assert out.save(2, state, force=True, cfg=cfg)
    assert out.saved_topology(2)["processes"] == 1
    out.close()
    back = launch.run_ranks(
        "torch_dist_cases:fit_case", 2,
        dict(ckpt_dir=d1, axes=dict(fsdp=2), steps=2, cfg_kw=CFG),
        env=RANK_ENV, cwd=REPO, timeout=240)[0]
    _assert_same(back, saved, "fsdp 1 -> 2")
    # A restore into another topology is a reshard.
    assert back["goodput"]["reshard"] > 0.0


def test_reshard_bucket_on_a_one_rank_resume(tmp_path):
    """fit at fsdp 1 resuming a checkpoint written by two ranks: the
    restore lands in `reshard`; resuming its own save does not (its
    restore, like every batch fast-forward, lands in `restore`)."""
    d = str(tmp_path / "ckpt")
    cfg = tllama.llama_tiny(**CFG)
    state = _state(cfg)
    mngr = ck.CheckpointManager(d)
    topo = {"processes": 2, "devices": 2,
            "axes": dict(tmesh.single_mesh("cpu").shape, fsdp=2)}
    assert mngr.save(1, state, force=True, cfg=cfg, topology=topo)
    mngr.close()
    for bucket, steps in (("reshard", 2), ("restore", 3)):
        rec = TrainRecorder()
        ttrain.fit(cfg, ttrain.make_optimizer(warmup_steps=2,
                                              decay_steps=50),
                   tdata.synthetic_batches(cfg.vocab_size, 2, 32, seed=0),
                   device="cpu", mesh=tmesh.single_mesh("cpu"),
                   max_steps=steps, ckpt_dir=d, recorder=rec,
                   log_fn=lambda *_: None)
        g = rec.goodput()
        assert g[bucket] > 0.0, (bucket, g)
        if bucket == "restore":
            assert g["reshard"] == 0.0, g


def test_save_is_single_writer_in_process(tmp_path):
    cfg = tllama.llama_tiny(**CFG)
    state = _state(cfg)
    d = str(tmp_path / "ckpt")
    rank0 = ck.CheckpointManager(d, save_interval_steps=1, process_index=0)
    rank1 = ck.CheckpointManager(d, save_interval_steps=1, process_index=1)
    with ck.CheckpointManager._inflight_lock:
        ck.CheckpointManager._inflight[rank0._dir] = id(rank0)
    try:
        with pytest.raises(RuntimeError, match="single-writer"):
            rank1.save(1, state)
    finally:
        with ck.CheckpointManager._inflight_lock:
            ck.CheckpointManager._inflight.pop(rank0._dir, None)
    assert rank1.save(1, state)
    rank0.close()
    rank1.close()


def test_quarantine_is_rank0_only(tmp_path):
    cfg = tllama.llama_tiny(**CFG)
    d = str(tmp_path / "ckpt")
    mngr = ck.CheckpointManager(d, save_interval_steps=1, process_index=0)
    state = _state(cfg)
    assert mngr.save(1, state)
    assert mngr.save(2, state, force=True)
    mngr.close()
    step_dir = os.path.join(d, "2")
    for root, _dirs, files in os.walk(step_dir):
        for fn in files:
            path = os.path.join(root, fn)
            with open(path, "r+b") as f:
                f.truncate(max(1, os.path.getsize(path) // 3))
    rank1 = ck.CheckpointManager(d, save_interval_steps=1, process_index=1)
    assert rank1.restore(_state(cfg)) is not None
    assert os.path.isdir(step_dir)
    assert not any(".corrupt" in n for n in os.listdir(d))
    rank0 = ck.CheckpointManager(d, save_interval_steps=1, process_index=0)
    assert rank0.restore(_state(cfg)) is not None
    assert not os.path.isdir(step_dir)
    assert any(".corrupt" in n for n in os.listdir(d))


def test_an_interleaved_layout_waits_for_the_pipeline(tmp_path):
    cfg = tllama.llama_tiny(**CFG)
    d = str(tmp_path / "ckpt")
    mngr = ck.CheckpointManager(d)
    assert mngr.save(1, _state(cfg), force=True)
    meta_path = os.path.join(d, "1", "state", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["layout"] = {"interleaved": True, "pp": 2, "v": 2}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="parallel/pipeline.py"):
        mngr.restore(_state(cfg), step=1)
