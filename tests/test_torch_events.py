"""Port of the flight recorder (metrics/events.py): the same sequence of
spans, instants, counters, complete and async events on the JAX
package's bus and on the port's, under one injected monotonic clock,
gives equal Chrome-trace dumps apart from the time anchor; each
package's merge_traces reads the other's dump (and JSONL stream) and
the two merges are equal. Tolerance: exact."""

import json
import threading
import time

import pytest

from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu_torch.metrics import events as tevents


@pytest.fixture(autouse=True)
def clean_buses():
    for mod in (jevents, tevents):
        mod._reset_for_tests()
    yield
    for mod in (jevents, tevents):
        # drive() shrinks the process-wide ring, which _reset_for_tests
        # keeps: give later tests in this process the default back.
        mod.enable(capacity=mod.DEFAULT_CAPACITY)
        mod._reset_for_tests()


class Clock:
    """time.monotonic replaced by a counter: 1000.000, 1000.001, ..."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return 1000.0 + self.n * 1e-3


def drive(mod, monkeypatch) -> dict:
    """One fixed sequence of every event kind through the module-level
    helpers and the bus; returns the bus's Chrome-trace dict."""
    monkeypatch.setattr(time, "monotonic", Clock())
    bus = mod.enable(process_name="parity", capacity=64)
    with mod.span("tick", "serve", {"slots": 3}):
        mod.instant("admit", "serve", {"rid": 1})
        mod.counter("serve/queue_depth", {"queued": 2})
    mod.complete("prefill", 1000.5, 0.25, "serve", {"tokens": 128})
    mod.async_begin("request", 7, "serve")
    mod.async_instant("first_token", 7, "serve")
    mod.async_end("request", 7, "serve", {"outcome": "ok"})
    bus.begin("outer", "x")
    bus.end("outer", "x")
    bus.instant("explicit_ts", "x", ts=999.0)
    mod.disable()
    mod.instant("dropped_while_off", "x")  # not recorded
    mod.enable()
    # Past the ring's capacity: the oldest are overwritten and counted.
    for i in range(70):
        mod.counter("fill", {"i": i})
    return bus.to_chrome()


def _without_anchor(trace: dict) -> dict:
    other = dict(trace["otherData"])
    other.pop("anchor")
    return {**trace, "otherData": other}


def test_dumps_equal_apart_from_the_anchor(monkeypatch):
    want = drive(jevents, monkeypatch)
    got = drive(tevents, monkeypatch)
    assert got["otherData"]["dropped"] == got["otherData"]["emitted"] - 64
    assert got["otherData"]["dropped"] > 0
    assert _without_anchor(got) == _without_anchor(want)
    assert set(got["otherData"]["anchor"]) == set(
        want["otherData"]["anchor"])


def test_debugz_payloads_equal(monkeypatch):
    drive(jevents, monkeypatch)
    want = jevents.get_bus().debugz(16)
    drive(tevents, monkeypatch)
    got = tevents.get_bus().debugz(16)
    for d in (want, got):
        d.pop("anchor")
    assert got == want


def test_each_merge_reads_the_others_dump(monkeypatch, tmp_path):
    drive(jevents, monkeypatch)
    jpath = jevents.get_bus().dump(str(tmp_path / "jax.json"))
    drive(tevents, monkeypatch)
    tpath = tevents.get_bus().dump(str(tmp_path / "torch.json"))
    sse = tmp_path / "sse.jsonl"
    sse.write_text("\n".join(json.dumps(e) for e in [
        {"token": 5, "ts": 1.0, "t": 1.7e9, "req": 1},
        {"done": True, "ts": 1.1, "t": 1.7e9 + 0.1, "req": 1}]))
    for paths in ([tpath], [jpath], [jpath, tpath]):
        want = jevents.merge_traces(paths, sse_log_paths=[str(sse)])
        got = tevents.merge_traces(paths, sse_log_paths=[str(sse)])
        assert got == want
        assert len(got["otherData"]["sources"]) == len(paths) + 1


def test_jsonl_streams_merge_alike(monkeypatch, tmp_path):
    paths = {}
    for name, mod in (("jax", jevents), ("torch", tevents)):
        writer = mod.stream_jsonl(str(tmp_path / f"{name}.jsonl"),
                                  flush_interval=0.01)
        drive(mod, monkeypatch)
        writer.close()
        paths[name] = writer.path
    for path in paths.values():
        want = jevents.merge_traces(event_jsonl_paths=[path])
        got = tevents.merge_traces(event_jsonl_paths=[path])
        assert got == want and got["traceEvents"]


def test_train_jsonl_source_waits_for_the_train_recorder(tmp_path):
    # The train recorder is ported: a step log it writes (every kind of
    # record, and a torn tail) merges as the JAX package merges it.
    from container_engine_accelerators_tpu_torch.metrics.train_metrics import (  # noqa: E501
        TrainRecorder,
    )

    path = str(tmp_path / "steps.jsonl")
    rec = TrainRecorder(log_path=path, flops_per_token=100.0,
                        peak_flops_per_chip=1e6, now=0.0)
    rec.record_restore(0.5, step=2, now=1.0)
    rec.record_fast_forward(0.1, batches=2, now=1.2)
    rec.record_step(3, compute_s=0.2, tokens=64, data_wait_s=0.05,
                    first=True, now=1.5)
    rec.record_step(4, compute_s=0.1, tokens=64, loss=2.5, now=1.7)
    rec.record_checkpoint_save(0.3, now=2.0, async_mode=True)
    rec.record_steps(2, 0.4, 128, now=2.5)
    rec.record_badput("detection", 0.2, now=2.6)
    rec.close()
    with open(path, "a") as f:
        f.write('{"kind": "step", "t": 1')
    missing = str(tmp_path / "missing.jsonl")
    want = jevents.merge_traces(train_jsonl_paths=[path, missing])
    got = tevents.merge_traces(train_jsonl_paths=[path, missing])
    assert got == want
    names = [e["name"] for e in got["traceEvents"] if e["ph"] != "M"]
    assert {"train/restore", "train/fast_forward", "train/step",
            "train/data_wait", "train/ckpt_save", "train/window",
            "train/badput"} <= set(names)


def test_dump_now_and_the_exit_hook_target(tmp_path, monkeypatch):
    # enable(dump_path=) arms the same dump path; signals stay off off the
    # main thread (the smoke's observe phase runs there). A test file
    # that ran before in this process may have installed the handler
    # from its main thread: start from the flag unset.
    monkeypatch.setattr(tevents, "_SIGNAL_INSTALLED", False)
    out = {}

    def arm():
        tevents.enable(dump_path=str(tmp_path) + "/", signals=True)
        out["path"] = tevents.dump_now()

    t = threading.Thread(target=arm)
    t.start()
    t.join()
    assert out["path"].endswith(".json")
    with open(out["path"]) as f:
        assert "traceEvents" in json.load(f)
    assert not tevents._SIGNAL_INSTALLED
