"""Port of the engine supervisor (serve --supervise) on the CPU: a worker
killed mid-decode fails its in-flight requests with "supervised
recovery", leaks no page, counts one restart and serves the next request
with the tokens it answered before; each engine's recovery; the backoff
ladder and the give-up, step for step as the JAX package's supervisor
takes them; a deliberate stop is not a death; and /healthz reports the
worker's life. Tokens are compared exactly (f32 weights carried across
with interop.params_from_jax); no logits are compared here."""

import json
import queue
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.cli import serve as jserve
from container_engine_accelerators_tpu.metrics import (
    request_metrics as jrm,
)
from container_engine_accelerators_tpu.models import decode as jdecode
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)
from container_engine_accelerators_tpu_torch.models import llama as tllama

SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
TIMEOUT = 120
PROMPT = list(range(1, 9))

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return params, jcfg, model, tcfg


def direct(weights, tokens, n_new):
    params, jcfg, _, _ = weights
    out = jdecode.generate(params, jnp.asarray([tokens], jnp.int32), jcfg,
                           n_new)
    return [int(t) for t in np.asarray(out)[0]]


def wait_until(cond, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _first_event(stream):
    while True:
        ev = stream.get(timeout=TIMEOUT)
        if "token" in ev or "error" in ev:
            return ev


def _last_event(stream):
    ev = None
    while True:
        try:
            ev = stream.get_nowait()
        except queue.Empty:
            return ev


def _engine(weights, kind, **kw):
    _, _, model, cfg = weights
    if kind == "paged":
        return serve.PagedContinuousEngine(model, cfg, max_slots=2,
                                           max_len=512, page=64,
                                           pool_pages=9, prefill_chunk=0,
                                           **kw)
    if kind == "continuous":
        return serve.ContinuousEngine(model, cfg, max_slots=2, max_len=512,
                                      prompt_bucket=16, **kw)
    return serve.BatchingEngine(model, cfg, max_batch=2, window_ms=5.0, **kw)


@pytest.mark.parametrize("kind,kw", [
    ("paged", {}), ("paged", {"prefix_cap": 0}),
    ("paged", {"speculate": "ngram"}), ("continuous", {}),
    ("continuous", {"speculate": "draft", "prefill_workers": 1})],
    ids=["paged", "paged-no-prefix-cache", "paged-spec", "continuous",
         "continuous-draft-pools"])
def test_worker_kill_mid_decode_is_recovered(weights, kind, kw):
    eng = _engine(weights, kind, draft_layers=1, **kw)
    rec = eng.recorder
    sup = serve.EngineSupervisor(eng, backoff_base_s=0.05,
                                 poll_interval_s=0.05)
    try:
        before = eng.submit(PROMPT, 4, 0.0).result(timeout=TIMEOUT)
        streams = [queue.Queue(), queue.Queue()]
        futs = [eng.submit(PROMPT, 400, 0.0, stream=st) for st in streams]
        for st in streams:
            assert "token" in _first_event(st)
        if kind == "paged":
            assert eng.pages_in_use > 0
        sup.start()
        eng.fault_kill = True
        for fut in futs:
            with pytest.raises(RuntimeError, match="supervised recovery"):
                fut.result(timeout=TIMEOUT)
        for st in streams:
            ev = _last_event(st)
            assert ev is not None and "error" in ev, ev
        wait_until(lambda: eng.worker_restarts == 1
                   and eng.thread.is_alive(), "the restart")
        assert sup.restarts == 1
        assert rec.registry.get_sample_value(
            "serve_worker_restarts_total") == 1
        assert rec.registry.get_sample_value("serve_active_slots") == 0
        assert eng._inflight == [] and eng._dev_tok is None
        assert all(sl is None for sl in eng._slots)
        if kind == "paged":
            assert eng.pages_in_use == 0
            assert eng._alloc.outstanding_rows() == {}
            assert rec.registry.get_sample_value(
                "serve_kv_pages_in_use") == 0
        # The restarted worker answers what it answered before the kill.
        assert eng.submit(PROMPT, 4, 0.0).result(timeout=TIMEOUT) == before
        assert before == direct(weights, PROMPT, 4)
        if kind == "paged":
            wait_until(lambda: all(sl is None for sl in eng._slots),
                       "slots released")
            with eng._mu:
                assert eng.pages_in_use == eng.prefix_index.pages_held()
    finally:
        sup.stop()
        eng.stop()
        eng.thread.join(timeout=30)


def test_window_engine_kill_is_recovered(weights):
    eng = _engine(weights, "window")
    sup = serve.EngineSupervisor(eng, backoff_base_s=0.05,
                                 poll_interval_s=0.05)
    try:
        before = eng.submit(PROMPT, 4, 0.0).result(timeout=TIMEOUT)
        # Killed before it takes the next batch: the queued request fails
        # with the supervisor's error, and the restart serves again.
        eng.fault_kill = True
        eng._work.set()
        wait_until(lambda: not eng.thread.is_alive(), "the kill")
        fut = eng.submit(PROMPT, 4, 0.0)
        sup.start()
        with pytest.raises(RuntimeError, match="supervised recovery"):
            fut.result(timeout=TIMEOUT)
        wait_until(lambda: eng.thread.is_alive() and eng.worker_restarts,
                   "the restart")
        assert eng.submit(PROMPT, 4, 0.0).result(timeout=TIMEOUT) == before
    finally:
        sup.stop()
        eng.stop()


class _DeadOnArrival:
    """An engine whose every worker dies at once: the supervisor's ladder
    with nothing else in the way."""

    def __init__(self, recorder):
        self.recorder = recorder
        self._stop = threading.Event()
        self.worker_restarts = 0
        self.recoveries = 0
        self._start_worker()

    def _start_worker(self):
        self.thread = threading.Thread(target=lambda: None)
        self.thread.start()
        self.thread.join()

    def recover_after_worker_death(self, err):
        assert "supervised recovery" in str(err)
        self.recoveries += 1


class _Waits:
    """Stands for the supervisor's stop Event: records each wait."""

    def __init__(self):
        self.waits = []

    def wait(self, seconds):
        self.waits.append(round(seconds, 9))
        return False

    def is_set(self):
        return False

    def set(self):
        pass


@pytest.mark.parametrize("base,cap,max_restarts",
                         [(0.5, 10.0, 16), (0.05, 0.3, 6), (1.0, 1.0, 2)])
def test_backoff_ladder_and_give_up_step_as_jax(base, cap, max_restarts):
    runs = []
    for pkg, rm in ((serve, trm), (jserve, jrm)):
        eng = _DeadOnArrival(rm.RequestRecorder())
        sup = pkg.EngineSupervisor(eng, backoff_base_s=base,
                                   backoff_cap_s=cap,
                                   max_restarts=max_restarts)
        sup._stop = _Waits()
        sup._loop()   # on this thread: returns when it gives up
        runs.append((sup._stop.waits, sup.restarts, sup.gave_up,
                     eng.recoveries, eng.worker_restarts,
                     eng.recorder.registry.get_sample_value(
                         "serve_worker_restarts_total")))
    assert runs[0] == runs[1]
    waits, restarts, gave_up, recoveries, _, counted = runs[0]
    assert gave_up and restarts == counted == max_restarts
    assert recoveries == max_restarts + 1
    assert waits == [min(cap, base * 2 ** i) for i in range(max_restarts)]


def test_supervisor_ignores_a_deliberate_stop(weights):
    eng = _engine(weights, "continuous")
    sup = serve.EngineSupervisor(eng, backoff_base_s=0.05,
                                 poll_interval_s=0.05)
    sup.start()
    eng.stop()
    wait_until(lambda: not eng.thread.is_alive(), "the worker to stop")
    time.sleep(0.3)
    assert sup.restarts == 0 and eng.worker_restarts == 0
    sup.stop()


def test_supervisor_gives_up_on_a_worker_that_keeps_dying(weights):
    eng = _engine(weights, "continuous")
    sup = serve.EngineSupervisor(eng, backoff_base_s=0.01,
                                 backoff_cap_s=0.02, max_restarts=2,
                                 poll_interval_s=0.02)

    def rekill():
        while not eng._stop.is_set() and not sup.gave_up:
            eng.fault_kill = True
            time.sleep(0.01)

    t = threading.Thread(target=rekill, daemon=True)
    try:
        eng.fault_kill = True
        sup.start()
        t.start()
        wait_until(lambda: sup.gave_up, "the give-up")
        assert sup.restarts == 2
        assert not eng.thread.is_alive()
    finally:
        sup.stop()
        eng.stop()
        t.join(timeout=10)


def test_healthz_reports_the_workers_life(weights):
    eng = _engine(weights, "paged", prefill_workers=1)
    srv = serve.make_server(eng, 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://localhost:{srv.server_address[1]}/healthz"

    def health():
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.loads(resp.read())

    sup = serve.EngineSupervisor(eng, backoff_base_s=0.05,
                                 poll_interval_s=0.05)
    try:
        wait_until(lambda: eng.prefill_workers_alive() == 1, "the pool")
        h = health()
        assert h["worker_alive"] and h["prefill_workers"] == 1
        assert h["prefill_workers_alive"] == 1 and h["worker_restarts"] == 0
        eng.fault_kill = True
        wait_until(lambda: not eng.thread.is_alive(), "the kill")
        assert health()["worker_alive"] is False
        sup.start()
        wait_until(lambda: health()["worker_alive"], "the restart")
        h = health()
        assert h["worker_restarts"] == 1 and h["prefill_workers_alive"] == 1
        assert eng.submit(PROMPT, 3, 0.0).result(
            timeout=TIMEOUT) == direct(weights, PROMPT, 3)
    finally:
        sup.stop()
        srv.shutdown()
        srv.server_close()
        eng.stop()
        th.join(timeout=30)
