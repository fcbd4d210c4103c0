"""Port of request tracing (metrics/trace.py) and the recorder's span
edges: head_sampled agrees bit for bit with the JAX package's over
10 000 request ids at rates 0, 0.01, 0.5 and 1; one scripted request
lifecycle through each package's RequestRecorder (on its own `now`
clock) gives the same spans per request, in the same order, with the
same tail-sampling decisions. Tolerance: exact."""

import time

import pytest

from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import request_metrics as jrm
from container_engine_accelerators_tpu.metrics import trace as jtrace
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)
from container_engine_accelerators_tpu_torch.metrics import trace as ttrace

PKGS = {"jax": (jevents, jtrace, jrm), "torch": (tevents, ttrace, trm)}


@pytest.fixture(autouse=True)
def clean():
    for ev, tr, _ in PKGS.values():
        tr._reset_for_tests()
        ev._reset_for_tests()
    yield
    for ev, tr, _ in PKGS.values():
        tr._reset_for_tests()
        ev._reset_for_tests()


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.5, 1.0])
def test_head_sampled_matches_jax(rate):
    ids = list(range(10_000))
    want = [jtrace.head_sampled(i, rate) for i in ids]
    assert [ttrace.head_sampled(i, rate) for i in ids] == want
    strs = [f"req-{i}" for i in range(1000)]
    assert ([ttrace.head_sampled(s, rate) for s in strs]
            == [jtrace.head_sampled(s, rate) for s in strs])
    if 0 < rate < 1:
        assert 0 < sum(want) < len(ids)


def lifecycle(pkg: str, rate: float) -> tuple[dict, dict]:
    """Five requests through a recorder on a synthetic clock: clean ones,
    a preempted one, a failed one, a forced one. Returns ({rid: [(ph,
    name, args)]} of the "req" spans, the tracer's stats)."""
    ev, tr, rm = PKGS[pkg]
    ev.enable(process_name="parity", capacity=ev.DEFAULT_CAPACITY)
    tr.configure(sample_rate=rate, slo_ttft_ms=500.0)
    rec = rm.RequestRecorder()
    t = 100.0
    tr.start(5, force=True, tags={"tenant": "0", "class": "chat"})
    for rid in range(1, 6):
        rec.enqueue(rid, now=t)
    for rid in range(1, 6):
        t += 0.01
        rec.admit(rid, now=t)
        h = tr.handle(rid)
        if h is not None:
            with h.span(tr.SPAN_PREFILL_CHUNK, {"tokens": 16}):
                pass
    for rid in (1, 2, 3, 5):
        t += 0.1
        rec.first_token(rid, now=t)
    rec.first_token(4, now=t + 1.0)            # over the TTFT SLO
    rec.preempt(2, now=t + 0.2)
    rec.admit(2, now=t + 0.3)
    rec.first_token(2, now=t + 0.4)
    for rid in (1, 2, 4, 5):
        for k in range(3):
            rec.decode_token(rid, now=t + 0.5 + 0.01 * k)
        rec.finish(rid)
    rec.fail(3)
    spans: dict = {}
    for e in ev.get_bus().to_chrome()["traceEvents"]:
        if e.get("cat") == "req":
            spans.setdefault(int(e["id"]), []).append(
                (e["ph"], e["name"], e.get("args")))
    return spans, tr.get().stats()


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_span_order_per_request_matches_jax(rate):
    want = lifecycle("jax", rate)
    got = lifecycle("torch", rate)
    assert got == want
    spans, _ = got
    # The forced, the preempted, the failed and the SLO-violating
    # requests are traced at any rate; at rate 1 every one is.
    assert {2, 3, 4, 5} <= set(spans)
    assert [n for _, n, _ in spans[5] if n.startswith("req/")][:3] == [
        "req/queue", "req/queue", "req/prefill"]


def test_tracer_is_off_with_the_bus_off():
    ttrace.configure(sample_rate=1.0)
    assert ttrace.start(1) is None and ttrace.handle(1) is None
    rec = trm.RequestRecorder()
    rec.enqueue(1, now=time.monotonic())
    rec.admit(1)
    rec.finish(1)
    assert tevents.get_bus().emitted == 0
