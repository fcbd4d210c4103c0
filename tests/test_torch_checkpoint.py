"""The port's CheckpointManager (training/checkpoint.py, raw tensor
files on the JAX package's directory layout) on the CPU: every behaviour of the
JAX package's tests/test_checkpoint.py that one process shows (interval,
force, keep-K, latest_step; no partial step after a failed save; the
leaked-tmp sweep, here synchronous; one writer per directory; async
saves; the torn newest step quarantined with a fallback; an empty
directory; load_serving_params), and fit resumed at step k against an
uninterrupted run (bit for bit) and against the JAX package's fit
resumed at k (the same batches consumed)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.training import checkpoint as ck
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import train as ttrain

CFG = tllama.llama_tiny(dtype=torch.float32, vocab_size=64, n_layers=2)


def _state(seed=0, steps=0):
    """A TrainState of CFG after `steps` steps on the smoke stream (the
    optimizer's moments exist once a step ran)."""
    model = tllama.init_train_params(CFG, torch.Generator().manual_seed(seed),
                                     "cpu")
    opt = ttrain.make_optimizer(learning_rate=1e-2, warmup_steps=1)(
        model.parameters())
    state = ttrain.TrainState(step=0, model=model, optimizer=opt)
    step_fn = ttrain.make_train_step(CFG, opt)
    for b in tdata.synthetic_batches(CFG.vocab_size, 2, 16,
                                     num_batches=steps, seed=seed):
        step_fn(model, ttrain.to_device(b, torch.device("cpu")))
        state.step += 1
        state.tokens += 32
    return state


def _tensors(state):
    out = {}
    for fname, ts in ck.state_tensors(state).items():
        for k, v in ts.items():
            out[f"{fname}:{k}"] = v.detach().clone()
    return out


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_save_restore_roundtrip_layout_and_meta(tmp_path):
    state = _state(steps=2)
    mngr = ck.CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
    assert mngr.save(2, state, cfg=CFG)
    step_dir = tmp_path / "c" / "2" / "state"
    assert sorted(os.listdir(step_dir)) == ["meta.json",
                                            "model.safetensors",
                                            "optimizer.safetensors"]
    meta = json.loads((step_dir / "meta.json").read_text())
    assert meta["format"] == ck.FORMAT_VERSION and meta["step"] == 2
    assert meta["tokens"] == 64 and meta["optimizer_count"] == 2
    assert tllama.cfg_from_json_dict(meta["cfg"]) == CFG
    assert mngr.last_save_info["bytes"] == sum(meta["files"].values())
    want = _tensors(state)
    fresh = _state(seed=1)
    assert mngr.restore(fresh) is fresh
    assert (fresh.step, fresh.tokens, fresh.optimizer.count) == (2, 64, 2)
    assert _equal(_tensors(fresh), want)
    assert mngr.last_restore_info["step"] == 2
    # load_model's rule detects the layout as a training checkpoint.
    assert convert.is_training_checkpoint(str(tmp_path / "c"))
    mngr.close()


def test_save_interval_force_keep_k_and_latest_step(tmp_path):
    state = _state()
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=3,
                                max_to_keep=2)
    assert mngr.latest_step() is None
    saved = [s for s in range(1, 11) if mngr.save(s, state)]
    assert saved == [3, 6, 9]
    assert mngr.all_steps() == [6, 9] and mngr.latest_step() == 9
    assert not mngr.save(9, state)        # not past the newest
    assert mngr.save(10, state, force=True)
    assert mngr.all_steps() == [9, 10]
    with pytest.raises(FileExistsError):
        mngr.save(10, state, force=True)


def test_a_save_that_raises_midway_leaves_no_step(tmp_path, monkeypatch):
    state = _state()
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert mngr.save(1, state)
    calls = []
    real = ck.safetensors.write

    def failing(f, tensors):
        calls.append(1)
        if len(calls) == 2:        # the optimizer file
            raise OSError("disk full")
        return real(f, tensors)

    monkeypatch.setattr(ck.safetensors, "write", failing)
    with pytest.raises(OSError, match="disk full"):
        mngr.save(2, state)
    assert sorted(os.listdir(tmp_path)) == ["1"]
    assert mngr.latest_step() == 1
    # The registry was released: the next save goes through.
    monkeypatch.setattr(ck.safetensors, "write", real)
    assert mngr.save(2, state)


def test_manager_init_sweeps_leaked_tmp_dirs_synchronously(tmp_path):
    # A writer killed mid-save leaves `<step>.tmp-*`; the next manager
    # removes it before its constructor returns (the JAX package's orbax
    # sweep runs on a background thread, and its test races it).
    for name in ("7.tmp-123-0", "8.tmp-9-4"):
        os.makedirs(tmp_path / name / "state")
    os.makedirs(tmp_path / "5" / "state")
    (tmp_path / "notes.txt").write_text("kept")
    mngr = ck.CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["5", "notes.txt"]
    assert mngr.all_steps() == [5]


def test_single_writer_per_directory(tmp_path, monkeypatch):
    state = _state()
    a = ck.CheckpointManager(str(tmp_path), save_interval_steps=1,
                             async_save=True)
    b = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    gate, entered = threading.Event(), threading.Event()
    commit = ck.CheckpointManager._commit

    def slow_commit(self, *args):
        entered.set()
        assert gate.wait(30)
        return commit(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_commit", slow_commit)
    assert a.save(1, state)
    assert entered.wait(30) and a.async_in_flight
    with pytest.raises(RuntimeError, match="concurrent checkpoint save"):
        b.save(2, state)
    gate.set()
    assert a.wait_async(timeout_s=30)
    assert not a.async_in_flight and a.all_steps() == [1]
    assert b.save(2, state)


def test_async_save_lands_snapshots_and_restores(tmp_path):
    # The snapshot is taken when save returns: later in-place updates of
    # the live state do not reach the written step.
    state = _state(steps=1)
    want = _tensors(state)
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=2,
                                async_save=True)
    assert not mngr.save(1, state)         # off the interval: nothing
    assert mngr.last_save_info is None and not mngr._pinned
    assert mngr.save(2, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    assert mngr.wait_async(timeout_s=60)
    assert mngr.all_steps() == [2] and mngr.last_save_info["step"] == 2
    fresh = _state(seed=3)
    mngr.restore(fresh)
    assert _equal(_tensors(fresh), want)
    mngr.close()


def test_async_save_off_the_interval_never_waits_for_the_write(
        tmp_path, monkeypatch):
    # Only a due save joins the write in flight; a step off the interval
    # (or one the pending save already covers) returns at once.
    state = _state()
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=2,
                                async_save=True)
    gate, entered = threading.Event(), threading.Event()
    commit = ck.CheckpointManager._commit

    def slow_commit(self, *args):
        entered.set()
        assert gate.wait(30)
        return commit(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_commit", slow_commit)
    assert mngr.save(2, state) and entered.wait(30)
    assert not mngr.save(3, state)
    assert not mngr.should_save(2) and mngr.should_save(4)
    assert mngr.async_in_flight and mngr.all_steps() == []
    gate.set()
    assert mngr.save(4, state)             # joins step 2's write first
    mngr.close()
    assert mngr.all_steps() == [2, 4] and not mngr._pinned


def test_sync_save_holds_no_host_copy(tmp_path):
    # A sync save writes the live tensors one at a time; only async mode
    # keeps snapshot buffers.
    state = _state(steps=1)
    want = _tensors(state)
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert mngr.save(1, state)
    assert not mngr._pinned and mngr.last_save_info["snapshot_s"] == 0.0
    fresh = _state(seed=3)
    mngr.restore(fresh)
    assert _equal(_tensors(fresh), want)


def test_fit_charges_async_joins_to_ckpt_async(tmp_path, monkeypatch):
    # The writes an async fit waits for (a due save joining the last
    # one, the end of the run) land in the ckpt_async bucket as joins.
    from container_engine_accelerators_tpu_torch.metrics import (
        train_metrics,
    )

    commit = ck.CheckpointManager._commit
    pause = 0.3

    def slow_commit(self, *args):
        time.sleep(pause)
        return commit(self, *args)

    monkeypatch.setattr(ck.CheckpointManager, "_commit", slow_commit)
    log_path = str(tmp_path / "steps.jsonl")
    rec = train_metrics.TrainRecorder(log_path=log_path)
    _fit(tllama.llama_tiny(dtype=torch.float32), 3, str(tmp_path / "c"), [],
         ckpt_async=True, recorder=rec)
    rec.close()
    records = train_metrics.read_metrics_jsonl(log_path)
    saves = [r for r in records if r["kind"] == "ckpt_save"]
    joins = [r for r in records if r.get("join")]
    assert len(saves) == 2 and all(r["async"] for r in saves)  # 2, then 3
    assert joins and all(r["bucket"] == "ckpt_async" for r in joins)
    assert joins[-1]["step"] == 3 and joins[-1]["seconds"] >= pause / 2
    assert rec.goodput()["ckpt_async"] >= sum(r["seconds"] for r in joins)
    assert ck.step_dirs(str(tmp_path / "c")) == [2, 3]


def test_failed_async_save_is_reported_by_the_next(tmp_path, monkeypatch,
                                                    caplog):
    state = _state()
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1,
                                async_save=True)

    def broken(f, tensors):
        raise OSError("no space")

    real = ck.safetensors.write
    monkeypatch.setattr(ck.safetensors, "write", broken)
    assert mngr.save(1, state)
    mngr.wait_async()
    assert mngr.all_steps() == [] and os.listdir(tmp_path) == []
    monkeypatch.setattr(ck.safetensors, "write", real)
    assert mngr.save(2, state)
    mngr.close()
    assert mngr.all_steps() == [2]
    assert "previous async checkpoint save (step 1) failed" in caplog.text


@pytest.mark.parametrize("torn", ["model.safetensors",
                                  "optimizer.safetensors", "meta.json"])
def test_restore_skips_torn_newest_checkpoint(tmp_path, torn):
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    old = _state(steps=1)
    mngr.save(1, old)
    want = _tensors(old)
    mngr.save(2, _state(steps=2))
    path = tmp_path / "2" / "state" / torn
    with open(path, "r+b") as f:
        f.truncate(max(1, os.path.getsize(path) // 3))
    fresh = _state(seed=5)
    assert mngr.restore(fresh).step == 1
    assert _equal(_tensors(fresh), want)
    assert sorted(os.listdir(tmp_path)) == ["1", "2.corrupt"]
    # The resumed run can save step 2 again.
    assert mngr.save(2, fresh)


def test_restore_explicit_step_fails_loudly_and_empty_dir_is_none(tmp_path):
    mngr = ck.CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert mngr.restore(_state()) is None
    mngr.save(1, _state())
    mngr.save(2, _state())
    (tmp_path / "2" / "state" / "model.safetensors").write_bytes(b"torn")
    with pytest.raises(ValueError, match="torn"):
        mngr.restore(_state(), step=2)
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    # A checkpoint of another model is refused, not loaded.
    other = tllama.init_train_params(
        tllama.llama_tiny(dtype=torch.float32, vocab_size=64, n_layers=1),
        torch.Generator().manual_seed(0), "cpu")
    state = ttrain.TrainState(0, other, ttrain.make_optimizer()(
        other.parameters()))
    with pytest.raises(ValueError, match="does not match"):
        mngr.restore(state, step=1)


def test_load_serving_params(tmp_path):
    state = _state(steps=1)
    mngr = ck.CheckpointManager(str(tmp_path / "c"), save_interval_steps=1)
    mngr.save(1, state)                      # no cfg recorded
    with pytest.raises(ValueError, match="no cfg record"):
        ck.load_serving_params(str(tmp_path / "c"))
    mngr.save(2, state, cfg=CFG)
    weights, cfg = ck.load_serving_params(str(tmp_path / "c"))
    assert cfg == CFG
    for name, p in state.model.named_parameters():
        assert torch.equal(weights[name], p.detach())
    model, cfg2 = convert.load_model(str(tmp_path / "c"), device="cpu")
    assert cfg2 == CFG and not any(p.requires_grad
                                   for p in model.parameters())
    assert torch.equal(model.layers[1].wq, state.model.layers[1].wq)
    with pytest.raises(FileNotFoundError):
        ck.load_serving_params(str(tmp_path / "empty"))


def _fit(cfg, steps, ckpt_dir, pulled, **kw):
    def stream():
        for i, b in enumerate(tdata.synthetic_batches(cfg.vocab_size, 2, 32,
                                                      seed=0)):
            pulled.append((i, b))
            yield b

    logs = []
    state, metrics = ttrain.fit(
        cfg, ttrain.make_optimizer(learning_rate=1e-2, warmup_steps=1),
        stream(), device="cpu", max_steps=steps, log_every=1,
        log_fn=logs.append, ckpt_dir=ckpt_dir, save_every=2, **kw)
    return state, logs


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_fit_resumed_at_k_is_bit_identical_to_uninterrupted(tmp_path,
                                                           ckpt_async):
    cfg = tllama.llama_tiny(dtype=torch.float32)
    full, full_logs = _fit(cfg, 6, None, [])
    d = str(tmp_path / "ckpt")
    _fit(cfg, 4, d, [], ckpt_async=ckpt_async)
    assert ck.step_dirs(d) == [2, 4]
    pulled = []
    resumed, logs = _fit(cfg, 6, d, pulled, ckpt_async=ckpt_async)
    assert logs[0] == "resumed from step 4" and logs[1:] == full_logs[4:]
    assert [i for i, _ in pulled] == list(range(6))   # 4 skipped
    assert (resumed.step, resumed.tokens) == (full.step, full.tokens)
    assert resumed.optimizer.count == 6
    for a, b in zip(resumed.model.parameters(), full.model.parameters()):
        assert torch.equal(a, b)
    assert ck.step_dirs(d) == [2, 4, 6]


def test_fit_consumes_the_batches_jax_fit_consumes_on_resume(tmp_path,
                                                             mesh8):
    # JAX's fit resumed at k fast-forwards its stream by k and trains on
    # the rest; the port's does the same with the same stream.
    from container_engine_accelerators_tpu.models import llama as jllama
    from container_engine_accelerators_tpu.training import data as jdata
    from container_engine_accelerators_tpu.training import train as jtrain

    k, n = 2, 4
    jcfg = jllama.llama_tiny(vocab_size=64)
    jpulled = []

    def jstream():
        for i, b in enumerate(jdata.synthetic_batches(64, 8, 32, seed=0)):
            jpulled.append((i, b))
            yield b

    jd = str(tmp_path / "jax")
    for steps in (k, n):
        jtrain.fit(jcfg, mesh8, jtrain.make_optimizer(), jstream(),
                   ckpt_dir=jd, save_every=k, max_steps=steps, log_every=0,
                   log_fn=lambda m: None)
    tcfg = tllama.llama_tiny(vocab_size=64, dtype=torch.float32)
    tpulled = []

    def tstream():
        for i, b in enumerate(tdata.synthetic_batches(64, 8, 32, seed=0)):
            tpulled.append((i, b))
            yield b

    td = str(tmp_path / "port")
    for steps in (k, n):
        ttrain.fit(tcfg, ttrain.make_optimizer(), tstream(), device="cpu",
                   ckpt_dir=td, save_every=k, max_steps=steps, log_every=0,
                   log_fn=lambda m: None)
    assert [i for i, _ in tpulled] == [i for i, _ in jpulled]
    assert [i for i, _ in tpulled] == list(range(k)) + list(range(n))
    for (_, tb), (_, jb) in zip(tpulled, jpulled):
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(tb[key], jb[key])
    # Both directories hold steps by the same rule.
    assert ck.step_dirs(td) == [2, 4] and convert.is_training_checkpoint(jd)


def test_safetensors_round_trip_keeps_dtypes_and_refuses_torn_files(
        tmp_path):
    from container_engine_accelerators_tpu_torch.utils import safetensors

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).view(2, 3),
               "d": torch.tensor(1.5), "e": torch.zeros(0, 4)}
    path = tmp_path / "x.safetensors"
    with open(path, "wb") as f:
        safetensors.write(f, tensors)
    got = safetensors.read(str(path))
    assert list(got) == list(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    data = path.read_bytes()
    path.write_bytes(data[:-3])
    with pytest.raises(ValueError, match="ends inside"):
        safetensors.read(str(path))
    path.write_bytes(data[:5])
    with pytest.raises(ValueError, match="truncated"):
        safetensors.read(str(path))
