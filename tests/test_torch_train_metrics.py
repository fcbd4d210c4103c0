"""The port's train recorder, hang watchdog and /metrics exporter
(metrics/train_metrics.py), held against the JAX package's: the same
edge sequence at fixed `now` values gives equal summaries, goodput
splits, JSONL records and metric families; then the JAX package's own
behaviours (tests/test_train_metrics.py) on the port: goodput across a
resume, the residual stall of a hang, MFU, the fenced window, the
watchdog, crash-safe JSONL, the exporter, fit and the train CLI on the
CPU."""

import json
import os
import re
import time
import urllib.request

import pytest

from container_engine_accelerators_tpu.metrics import (
    train_metrics as jtm,
)
from container_engine_accelerators_tpu_torch.metrics import (
    train_metrics as ttm,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama
from container_engine_accelerators_tpu_torch.training import data as tdata
from container_engine_accelerators_tpu_torch.training import (
    dataset as tdataset,
)
from container_engine_accelerators_tpu_torch.training import train as ttrain

PEAK = 1e6   # the parity runs give both recorders the same peak


def scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def _drive(rec):
    """One edge sequence with every kind of record, at fixed times."""
    rec.record_restore(2.0, step=4, now=102.0)
    rec.record_fast_forward(1.0, batches=4, now=103.0)
    rec.record_step(5, compute_s=4.0, tokens=100, data_wait_s=0.5,
                    first=True, now=107.5)
    rec.record_host_sync(0.25)
    rec.record_step(6, compute_s=2.0, tokens=100, data_wait_s=0.5,
                    loss=3.25, now=110.0)
    rec.record_checkpoint_save(1.0, now=111.0)
    rec.record_step(7, compute_s=1.5, tokens=80, loss=3.0, now=113.0)
    rec.record_checkpoint_save(0.125, now=113.5, async_mode=True)
    rec.record_restore(0.5, step=7, resharded=True, now=114.0)
    rec.record_badput("restart", 0.75, detail={"why": "x"}, now=115.0)
    rec.record_steps(4, 2.0, 400, now=117.0)


def _families(registry) -> set:
    return {m.name for m in registry.collect()}


def _untimed(records):
    """JSONL records without `t`, the wall-clock stamp of each write."""
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


@pytest.mark.parametrize("configured", [True, False])
def test_same_edges_give_jax_summaries_goodput_and_jsonl(tmp_path,
                                                         configured):
    recs = {}
    for name, mod in (("jax", jtm), ("port", ttm)):
        path = str(tmp_path / f"{name}.jsonl")
        kw = dict(flops_per_token=100.0, peak_flops_per_chip=PEAK,
                  n_chips=2) if configured else {}
        rec = mod.TrainRecorder(log_path=path, now=100.0, **kw)
        _drive(rec)
        recs[name] = (rec, path)
    (j, jpath), (t, tpath) = recs["jax"], recs["port"]
    assert t.summary(now=120.0) == j.summary(now=120.0)
    assert t.goodput(now=121.0) == j.goodput(now=121.0)
    assert t.tokens_per_sec() == j.tokens_per_sec()
    assert t.mfu() == j.mfu()
    assert t.last_step_age(now=118.0) == j.last_step_age(now=118.0)
    for kind in ttm.SAMPLE_KINDS:
        assert t.pct_ms(kind) == j.pct_ms(kind), kind
    j.close()
    t.close()
    assert _untimed(ttm.read_metrics_jsonl(tpath)) == _untimed(
        jtm.read_metrics_jsonl(jpath))
    assert ttm.GOODPUT_BUCKETS == jtm.GOODPUT_BUCKETS
    assert ttm.SAMPLE_KINDS == jtm.SAMPLE_KINDS


def test_registered_families_and_samples_equal_jax(tmp_path):
    regs = {}
    for name, mod in (("jax", jtm), ("port", ttm)):
        rec = mod.TrainRecorder(flops_per_token=100.0,
                                peak_flops_per_chip=PEAK, now=100.0)
        _drive(rec)
        rec.goodput(now=120.0)
        mod.HangWatchdog(str(tmp_path / name), registry=rec.registry)
        regs[name] = rec.registry
    assert _families(regs["port"]) == _families(regs["jax"])

    def samples(reg):
        return {(s.name, tuple(sorted(s.labels.items()))): s.value
                for m in reg.collect() for s in m.samples
                if not s.name.endswith("_created")}

    assert samples(regs["port"]) == samples(regs["jax"])


def test_unknown_peak_reports_no_mfu(monkeypatch):
    # The JAX package falls back to a TPU's peak; the port reports no
    # MFU where it does not know the card (the CPU here).
    assert ttm.detect_peak_flops() is None
    rec = ttm.TrainRecorder(flops_per_token=100.0, now=0.0)
    rec.record_step(1, compute_s=1.0, tokens=10, now=1.0)
    rec.record_step(2, compute_s=1.0, tokens=10, now=2.0)
    assert rec.mfu() == 0.0 and rec.tokens_per_sec() == 10.0
    assert rec.registry.get_sample_value("train_mfu") == 0.0
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert ttm.detect_peak_flops() == 989e12
    assert ttm.detect_peak_flops(torch.device("cuda", 0)) == 989e12
    # The training device decides: a model on the CPU has no card peak.
    assert ttm.detect_peak_flops(torch.device("cpu")) is None
    # Only the SXM H100 runs at 989 TFLOP/s.
    for name in ("NVIDIA A100-SXM4-40GB", "NVIDIA H100 PCIe",
                 "NVIDIA H100 NVL"):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, name=name: name)
        assert ttm.detect_peak_flops() is None, name


def test_process_id_host_id_and_start_ticks(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    assert ttm.infer_process_id() == 3
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("JOB_COMPLETION_INDEX", "5")
    assert ttm.infer_process_id() == 5
    monkeypatch.delenv("JOB_COMPLETION_INDEX")
    monkeypatch.setenv("HOSTNAME", "trainer-7")
    assert ttm.infer_process_id() == 7
    assert ttm.host_id() == jtm.host_id()
    assert ttm.proc_start_ticks(os.getpid()) == jtm.proc_start_ticks(
        os.getpid())
    assert ttm.proc_start_ticks(2 ** 31 - 2) is None


# ---------- the JAX package's behaviours, on the port ----------

def test_goodput_buckets_synthetic_resume():
    rec = ttm.TrainRecorder(now=100.0)
    rec.record_restore(2.0, step=4, now=102.0)
    rec.record_fast_forward(1.0, batches=4, now=103.0)
    rec.record_step(5, compute_s=4.0, tokens=100, data_wait_s=0.5,
                    first=True, now=107.5)
    rec.record_step(6, compute_s=2.0, tokens=100, data_wait_s=0.5,
                    now=110.0)
    rec.record_checkpoint_save(1.0, now=111.0)
    g = rec.goodput(now=112.0)
    assert g["restore"] == pytest.approx(3.0)
    assert g["recompile"] == pytest.approx(4.0)
    assert g["productive"] == pytest.approx(2.0)
    assert g["checkpoint"] == pytest.approx(1.0)
    assert g["stalled"] == pytest.approx(2.0)
    assert g["goodput_fraction"] == pytest.approx(2.0 / 12.0)
    v = rec.registry.get_sample_value
    assert v("train_goodput_seconds", {"bucket": "restore"}) == 3.0
    assert v("train_resumes_total") == 1.0
    with pytest.raises(ValueError, match="unknown goodput bucket"):
        rec.record_badput("nowhere", 1.0)


def test_goodput_residual_grows_during_hang():
    rec = ttm.TrainRecorder(now=0.0)
    rec.record_step(1, compute_s=1.0, tokens=10, now=1.0)
    assert rec.goodput(now=1.0)["stalled"] == pytest.approx(0.0)
    assert rec.goodput(now=61.0)["stalled"] == pytest.approx(60.0)
    assert rec.last_step_age(now=61.0) == pytest.approx(60.0)


def test_mfu_pinned_against_hand_computed_cfg():
    cfg = tllama.llama3_8b()
    fpt = cfg.train_flops_per_token(2048)
    rec = ttm.TrainRecorder(flops_per_token=fpt, peak_flops_per_chip=989e12,
                            n_chips=1, now=0.0)
    rec.record_step(1, compute_s=10.0, tokens=500, first=True, now=10.0)
    rec.record_step(2, compute_s=2.0, tokens=1000, now=12.0)
    assert rec.tokens_per_sec() == pytest.approx(500.0)
    assert rec.mfu() == pytest.approx(500.0 * fpt / 989e12)


def test_fenced_window_matches_wallclock_estimator():
    rec = ttm.TrainRecorder(flops_per_token=100.0, peak_flops_per_chip=1e6,
                            now=0.0)
    rec.record_steps(8, 4.0, 8 * 1000, now=4.0)
    rec.record_steps(8, 4.0, 8 * 1000, now=8.0)
    assert rec.tokens_per_sec() == pytest.approx(2000.0)
    assert rec.mfu() == pytest.approx(2000.0 * 100.0 / 1e6)
    assert rec.pct("step")["p50"] == pytest.approx(0.5)


def test_watchdog_fires_on_stale_and_clears_on_touch(tmp_path):
    hb = str(tmp_path / "hb")
    rec = ttm.TrainRecorder(heartbeat_dir=hb, process_id=3, now=0.0)
    rec.record_step(1, compute_s=0.01, tokens=1, now=1.0)
    stalls = []
    wd = ttm.HangWatchdog(hb, threshold_s=60.0, registry=rec.registry,
                          on_stall=lambda p, age: stalls.append(p))
    v = rec.registry.get_sample_value
    assert wd.check() == [] and v("train_stalled") == 0.0
    assert v("train_stalled_process") == -1.0
    path = os.path.join(hb, "hb-3")
    assert open(path).read().split()[:2] == [str(os.getpid()), "1"]
    old = time.time() - 120
    os.utime(path, (old, old))
    assert wd.check() == [3] and stalls == [3]
    assert v("train_stalled") == 1.0 and v("train_stalled_process") == 3.0
    assert v("train_heartbeat_age_seconds", {"process": "3"}) >= 60.0
    rec.record_step(2, compute_s=0.01, tokens=1, now=2.0)
    assert wd.check() == [] and v("train_stalled") == 0.0
    rec.close()
    assert not os.path.exists(path)     # a clean exit deregisters


def test_watchdog_names_oldest_straggler_and_runs_a_thread(tmp_path):
    hb = str(tmp_path / "hb")
    for pid in (0, 1, 2):
        ttm.TrainRecorder(heartbeat_dir=hb, process_id=pid).record_step(
            1, compute_s=0.01, tokens=1)
    now = time.time()
    os.utime(os.path.join(hb, "hb-1"), (now - 200, now - 200))
    os.utime(os.path.join(hb, "hb-2"), (now - 400, now - 400))
    wd = ttm.HangWatchdog(hb, threshold_s=100.0, interval_s=0.05)
    assert wd.check() == [2, 1]
    assert wd.registry.get_sample_value("train_stalled_process") == 2.0
    wd.start()
    wd.stop()
    assert not wd._thread.is_alive()


def test_jsonl_parseable_after_midline_truncation_and_across_resumes(
        tmp_path):
    path = str(tmp_path / "steps.jsonl")
    rec = ttm.TrainRecorder(log_path=path, now=0.0)
    for s in range(1, 4):
        rec.record_step(s, compute_s=0.5, tokens=10, now=float(s))
    rec.close()
    rec2 = ttm.TrainRecorder(log_path=path, now=10.0)
    rec2.record_restore(0.5, step=3, now=10.5)
    rec2.record_step(4, compute_s=0.1, tokens=5, now=11.0)
    rec2.close()
    kinds = [r["kind"] for r in ttm.read_metrics_jsonl(path)]
    assert kinds == ["step"] * 3 + ["restore", "step"]
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-7])
    kinds = [r["kind"] for r in ttm.read_metrics_jsonl(path)]
    assert kinds == ["step"] * 3 + ["restore"]
    assert ttm.read_metrics_jsonl(str(tmp_path / "missing")) == []


class _CoPoller:
    polls = 0

    def poll_once(self):
        self.polls += 1


def test_exporter_scrape_smoke_port0_with_co_exporters():
    rec = ttm.TrainRecorder(now=0.0)
    rec.record_step(1, compute_s=0.1, tokens=64, first=True, now=0.2)
    rec.record_step(2, compute_s=0.1, tokens=64, now=0.4)
    co = _CoPoller()
    exp = ttm.TrainMetricsExporter(rec, port=0, host="127.0.0.1",
                                   co_exporters=[co])
    exp.start_background()
    try:
        exp.poll_once()
        body = scrape(exp.bound_port)
    finally:
        exp.stop()
    assert co.polls >= 1
    assert "train_step_seconds_count 2.0" in body
    assert "train_tokens_total 128.0" in body
    for family in ("train_tokens_per_sec", "train_mfu",
                   "train_goodput_seconds", "train_goodput_fraction",
                   "train_last_step", "tpu_trace_events_emitted_total"):
        assert family in body, family


def test_fit_exposes_metrics_and_crash_safe_log(tmp_path):
    cfg = tllama.llama_tiny(vocab_size=64, dtype=__import__("torch").float32)
    jsonl = str(tmp_path / "steps.jsonl")
    hb = str(tmp_path / "hb")
    logs, seen = [], {}

    def batches():
        for i, b in enumerate(tdata.synthetic_batches(64, 4, 32,
                                                      num_batches=5)):
            if i == 4:
                port = int(re.search(r":(\d+)/metrics", logs[0]).group(1))
                seen["body"] = scrape(port)
                seen["hb_live"] = os.path.exists(os.path.join(hb, "hb-0"))
            yield b

    state, _ = ttrain.fit(cfg, ttrain.make_optimizer(), batches(),
                          device="cpu", metrics_port=0, metrics_log=jsonl,
                          heartbeat_dir=hb, log_every=2,
                          log_fn=logs.append)
    assert state.step == 5
    for family in ("train_step_seconds", "train_data_wait_seconds",
                   "train_tokens_per_sec", "train_mfu",
                   "train_goodput_seconds", "train_host_sync_seconds",
                   "train_stalled", "tpu_hbm_bytes_in_use"):
        assert family in seen["body"], family
    assert "train_steps_total 4.0" in seen["body"]
    steps = [r for r in ttm.read_metrics_jsonl(jsonl) if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5]
    assert steps[0].get("first") is True
    assert all(r["tokens"] == 4 * 32 for r in steps)
    assert "loss" in steps[0] and "loss" in steps[2]
    assert seen["hb_live"] is True
    assert not os.path.exists(os.path.join(hb, "hb-0"))


def test_a_data_stall_lands_in_stalled_and_trips_the_watchdog(tmp_path):
    # The chaos stall hook (training/dataset.inject_stall) sleeps inside
    # the batch iterator: the step's data wait, the `stalled` bucket and
    # the watchdog all see it.
    import torch

    cfg = tllama.llama_tiny(vocab_size=64, dtype=torch.float32)
    hb = str(tmp_path / "hb")
    rec = ttm.TrainRecorder(heartbeat_dir=hb, process_id=0)
    flagged = []
    wd = ttm.HangWatchdog(hb, threshold_s=0.2, interval_s=0.05,
                          registry=rec.registry,
                          on_stall=lambda p, age: flagged.append(p))

    def batches():
        for i, b in enumerate(tdata.synthetic_batches(64, 2, 16)):
            if i == 1:
                tdataset.inject_stall(once_s=0.6)
            yield b

    wd.start()
    try:
        ttrain.fit(cfg, ttrain.make_optimizer(), batches(), device="cpu",
                   max_steps=3, recorder=rec, log_every=0)
    finally:
        wd.stop()
        tdataset.clear_stall()
    assert flagged and set(flagged) == {0}
    assert rec.goodput()["stalled"] >= 0.6
    assert max(rec.samples["data_wait"]) >= 0.6
    assert tdataset.maybe_stall() == 0.0     # one-shot: consumed
    rec.close()


def test_stall_hook_equals_jax(monkeypatch):
    from container_engine_accelerators_tpu.training import (
        dataset as jdataset,
    )

    slept = {"jax": [], "port": []}
    for name, mod in (("jax", jdataset), ("port", tdataset)):
        monkeypatch.setattr(mod.time, "sleep", slept[name].append)
        mod.clear_stall()
        mod.inject_stall(once_s=0.5)
        mod.inject_stall(once_s=0.2, per_batch_s=0.1)
        got = [mod.maybe_stall() for _ in range(3)]
        mod.clear_stall()
        assert mod.maybe_stall() == 0.0
        slept[name].append(got)
    assert slept["port"] == slept["jax"]
    assert slept["port"][-1] == [0.6, 0.1, 0.1]


def test_train_cli_metrics_and_heartbeat_on_the_cpu(tmp_path, capsys):
    from container_engine_accelerators_tpu_torch.cli import train as tcli

    jsonl = str(tmp_path / "steps.jsonl")
    rc = tcli.main(["--device", "cpu", "--preset", "tiny", "--vocab-size",
                    "64", "--steps", "3", "--batch-size", "2", "--seq-len",
                    "16", "--metrics-port", "0", "--metrics-host",
                    "127.0.0.1", "--metrics-log", jsonl, "--heartbeat-dir",
                    str(tmp_path / "hb"), "--watchdog-threshold", "30",
                    "--trace-dump", str(tmp_path / "trace.json")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 3 and out["final_step"] == 3
    assert set(out["goodput"]) >= set(ttm.GOODPUT_BUCKETS)
    assert out["mfu"] == 0.0      # no known peak on the CPU
    assert len([r for r in ttm.read_metrics_jsonl(jsonl)
                if r["kind"] == "step"]) == 3
    assert not os.listdir(str(tmp_path / "hb"))
    from container_engine_accelerators_tpu_torch.metrics import events
    events._reset_for_tests()


def test_train_loop_feeds_the_recorder():
    import torch

    cfg = tllama.llama_tiny(vocab_size=64, dtype=torch.float32)
    model = tllama.init_train_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    opt = ttrain.make_optimizer()(model.parameters())
    state = ttrain.TrainState(step=0, model=model, optimizer=opt)
    rec = ttm.TrainRecorder(now=0.0)
    state, _ = ttrain.train_loop(
        state, tdata.synthetic_batches(64, 2, 16, num_batches=3),
        ttrain.make_train_step(cfg, opt), log_every=2, log_fn=lambda m: None,
        recorder=rec)
    s = rec.summary()
    assert state.step == 3 and s["steps"] == 3 and s["tokens"] == 3 * 32
    assert len(rec.samples["host_sync"]) == 2     # steps 1 and 3
    assert rec.registry.get_sample_value("train_last_step") == 3.0
    assert rec.registry.get_sample_value("train_loss") > 0
