"""Port of the serving engines' observability: one request script runs
through the JAX package's engine and the port's, each with its own
RequestRecorder and flight recorder (trace sample rate 1), for the
window, continuous and paged engines, the paged one with prefix sharing
and preemption. Each engine's worker starts only once the whole script
is queued, so both schedule the same ticks. The two must agree on every
counter, every histogram's sample count (times are not compared), the
occupancy gauges after the drain, the paged pool's census per tenant,
the spans per request and the set of metric names in the two /metrics
scrapes (less the families of the speculative, prefill-pool and
supervisor features, which the port does not have yet). Host-phase
samples must be present, and the greedy tokens still equal JAX's. On a
one-layer f32 llama_tiny, weights carried across by
interop.params_from_jax. Tolerance: exact."""

import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch
from prometheus_client.parser import text_string_to_metric_families

from container_engine_accelerators_tpu.cli import serve as jserve
from container_engine_accelerators_tpu.metrics import events as jevents
from container_engine_accelerators_tpu.metrics import request_metrics as jrm
from container_engine_accelerators_tpu.metrics import trace as jtrace
from container_engine_accelerators_tpu.models import llama as jllama
from container_engine_accelerators_tpu_torch import interop
from container_engine_accelerators_tpu_torch.cli import serve as tserve
from container_engine_accelerators_tpu_torch.metrics import events as tevents
from container_engine_accelerators_tpu_torch.metrics import (
    request_metrics as trm,
)
from container_engine_accelerators_tpu_torch.metrics import trace as ttrace
from container_engine_accelerators_tpu_torch.models import llama as tllama

SMALL = dict(n_layers=1, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
             vocab_size=128)
TIMEOUT = 180
PKGS = {"jax": (jserve, jrm, jevents, jtrace),
        "torch": (tserve, trm, tevents, ttrace)}
# Families of features the port has not yet (speculation, prefill pools,
# the supervisor): in the JAX scrape only.
NOT_YET = ("serve_spec_", "serve_pool_queue_depth", "serve_worker_restarts",
           "serve_prefill_worker_restarts")
# Gauges and histograms whose values follow the wall clock.
TIMED = ("serve_host_gap_fraction", "serve_kv_pages_by_temperature",
         "serve_kv_working_set_pages", "serve_kv_tenant_pages",
         "serve_kv_page_idle_seconds")

PREFIX = list(range(1, 33))                  # two pages of 16
SCRIPTS = {
    "window": [([1, 2, 3], 5), ([4, 5, 6], 5), ([4, 5], 7), ([9] * 6, 3),
               ([], 4)],                                   # invalid
    "continuous": [([1, 2, 3], 5), ([4, 5], 7), ([9, 8, 7, 6, 5, 4], 3),
                   ([17] * 20, 6), ([2], 24), ([3, 1, 4, 1, 5], 9),
                   ([1] * 60, 90)],                        # too long
    "paged": [(PREFIX + [40, 41], 8), ([60, 61, 62], 60), ([90] * 20, 60),
              (PREFIX + [70, 71, 72], 8), (PREFIX + [80], 8),
              ([5] * 65, 4)],                              # too long
}
ENGINE_KW = {
    "window": dict(max_batch=4, window_ms=50.0),
    "continuous": dict(max_slots=3, max_len=128, prompt_bucket=16,
                       max_prompt_len=64, prefill_chunk=16),
    # 8 usable pages: the first prompt leaves PREFIX's two pages in the
    # prefix cache for the fourth and fifth, and the second and third
    # slots' growth to 4 and 5 pages preempts the youngest.
    "paged": dict(max_slots=3, max_len=128, page=16, pool_pages=9,
                  max_prompt_len=64, prefill_chunk=16, prefix_cap=8),
}
TAGS = [{"tenant": str(i % 2), "class": "chat"} for i in range(8)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.llama_tiny(dtype=jnp.float32, **SMALL)
    tcfg = tllama.llama_tiny(dtype=torch.float32, **SMALL)
    params = jllama.init_params(jax.random.key(0), jcfg)
    model = interop.params_from_jax(jax.device_get(params), tcfg)
    return {"jax": (params, jcfg), "torch": (model, tcfg)}


@pytest.fixture(autouse=True)
def clean():
    for _, _, ev, tr in PKGS.values():
        tr._reset_for_tests()
        ev._reset_for_tests()
    yield
    for _, _, ev, tr in PKGS.values():
        tr._reset_for_tests()
        ev._reset_for_tests()


def _classes(serve, kind):
    return {"window": serve.BatchingEngine,
            "continuous": serve.ContinuousEngine,
            "paged": serve.PagedContinuousEngine}[kind]


def run_script(pkg, kind, weights, monkeypatch):
    """The script through one package's engine; (answers, recorder,
    spans per request, census after the drain, engine counters)."""
    serve, rm, ev, tr = PKGS[pkg]
    # An explicit capacity: another test in this process may have left
    # the process-wide ring smaller (_reset_for_tests keeps it).
    ev.enable(process_name=pkg, capacity=ev.DEFAULT_CAPACITY)
    tr.configure(sample_rate=1.0)
    cls = _classes(serve, kind)
    gate = threading.Event()
    worker = cls._worker

    def gated(self):
        gate.wait(TIMEOUT)
        return worker(self)

    monkeypatch.setattr(cls, "_worker", gated)
    rec = rm.RequestRecorder()
    model, cfg = weights[pkg]
    eng = cls(model, cfg, recorder=rec, engine_core="async",
              **ENGINE_KW[kind])
    futs = [eng.submit(list(t), n, 0.0, trace_ctx={"tags": TAGS[i]})
            for i, (t, n) in enumerate(SCRIPTS[kind])]
    gate.set()
    answers = []
    for fut in futs:
        try:
            answers.append([int(x) for x in fut.result(timeout=TIMEOUT)])
        except ValueError as e:
            answers.append(f"error: {type(e).__name__}")
    deadline = time.monotonic() + 30
    while (rec.registry.get_sample_value("serve_active_slots") != 0
           and time.monotonic() < deadline):
        time.sleep(0.02)
    time.sleep(0.2)       # one more idle iteration refreshes the gauges
    census = None
    if kind == "paged":
        c = eng.thermal_census()
        census = {k: c[k] for k in ("pages_total", "pages_in_use",
                                    "free_pages", "active_pages",
                                    "prefix_pages", "tenants")}
        census["buckets_sum"] = sum(c["buckets"].values())
    counters = {k: getattr(eng, k, None) for k in (
        "requests_served", "batches_run", "preemptions",
        "prefix_pages_reused", "prefill_chunks_run", "prefill_tokens_run")}
    eng.stop()
    eng.thread.join(timeout=30)
    assert not eng.thread.is_alive()
    spans: dict = {}
    for e in ev.get_bus().to_chrome()["traceEvents"]:
        if e.get("cat") == "req":
            spans.setdefault(int(e["id"]), []).append((e["ph"], e["name"]))
    return answers, rec, spans, census, counters


def values(rec) -> dict:
    """name{labels} -> value of every counter and gauge sample and every
    histogram's _count, less the clock-valued families."""
    out = {}
    for fam in rec.registry.collect():
        if fam.name.startswith(NOT_YET + TIMED):
            continue
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            key = s.name + str(sorted(s.labels.items()))
            out[key] = s.value
    return out


@pytest.mark.parametrize("kind", ["window", "continuous", "paged"])
def test_recorder_matches_jax(weights, monkeypatch, kind):
    j_ans, j_rec, j_spans, j_census, j_counts = run_script(
        "jax", kind, weights, monkeypatch)
    t_ans, t_rec, t_spans, t_census, t_counts = run_script(
        "torch", kind, weights, monkeypatch)
    assert t_ans == j_ans
    assert sum(isinstance(a, str) for a in t_ans) == 1   # the invalid one
    assert values(t_rec) == values(j_rec)
    assert t_counts == j_counts
    assert t_census == j_census
    assert t_spans == j_spans
    phases = set(t_rec.host_phase_ms())
    want = ({"admit", "schedule", "fetch", "stream"} if kind == "window"
            else {"admit", "schedule", "sample", "fetch", "stream"})
    assert phases == want
    assert 0.0 <= t_rec.host_gap() <= 1.0
    v = values(t_rec)
    assert v["serve_requests_total[('outcome', 'ok')]"] == len(t_ans) - 1
    assert v["serve_validation_failures_total[]"] == 1
    if kind == "paged":
        assert t_counts["preemptions"] > 0
        assert v["serve_prefix_hits_total[]"] > 0
        assert v["serve_kv_pages_in_use[]"] == t_census["prefix_pages"]
        assert set(t_census["tenants"]) <= {"0", "1"}


def _scrape_names(rm, rec) -> set:
    exp = rm.ServeMetricsExporter(rec, port=0, host="127.0.0.1")
    exp.start_background()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exp.bound_port}/metrics",
                timeout=30) as resp:
            text = resp.read().decode()
    finally:
        exp.stop()
    return {s.name for fam in text_string_to_metric_families(text)
            for s in fam.samples if not fam.name.startswith(NOT_YET)}


def test_metrics_scrapes_carry_the_same_names():
    # Fresh recorders, one observation of each edge, scraped over HTTP.
    names = {}
    for pkg, (_, rm, _, _) in PKGS.items():
        rec = rm.RequestRecorder()
        rec.enqueue(1, now=1.0)
        rec.admit(1, now=1.5)
        rec.first_token(1, now=2.0)
        rec.decode_token(1, now=2.1)
        rec.observe_decode_step(0.01)
        rec.observe_host_phase("admit", 0.001)
        rec.observe_host_tick(0.001, 0.01)
        rec.prefix_lookup(hit=True)
        rec.set_kv_thermal({"buckets": {"hot": 1}, "tenants": {
            "0": {"pages": 1, "cold": 0}}, "working_set_pages": 1,
            "idle_values": [0.5]})
        rec.finish(1)
        names[pkg] = _scrape_names(rm, rec)
    assert names["torch"] == names["jax"]
    assert "serve_ttft_seconds_count" in names["torch"]
    assert "tpu_trace_events_dropped_total" in names["torch"]


def test_recorder_and_census_hold_under_concurrent_threads(weights):
    # The recorder is shared by HTTP threads and the engine thread, and
    # the paged pool's census is read from HTTP threads while the worker
    # moves pages: with more threads than cores and a short switch
    # interval, no update is lost and no census fails mid-change.
    import sys

    rec = trm.RequestRecorder()
    threads, per_thread, tokens = 16, 50, 3

    def client(base):
        for rid in range(base, base + per_thread):
            rec.enqueue(rid)
            rec.admit(rid)
            rec.first_token(rid)
            for _ in range(tokens):
                rec.decode_token(rid)
            rec.observe_host_phase("stream", 1e-4, hidden=rid % 2 == 0)
            rec.finish(rid)

    model, cfg = weights["torch"]
    eng = tserve.PagedContinuousEngine(
        model, cfg, max_slots=3, max_len=128, page=16, pool_pages=12,
        max_prompt_len=64, prefill_chunk=16, recorder=trm.RequestRecorder(),
        thermal_interval_s=0.0)
    censuses, errors = [], []

    def reader(stop):
        while not stop.is_set():
            try:
                censuses.append(eng.thermal_census())
            except Exception as e:   # a census torn by the worker
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    stop = threading.Event()
    try:
        workers = [threading.Thread(target=client, args=(i * 1000,))
                   for i in range(threads)]
        readers = [threading.Thread(target=reader, args=(stop,))
                   for _ in range(2)]
        for t in workers + readers:
            t.start()
        futs = [eng.submit(list(t), n, 0.0, trace_ctx={"tags": TAGS[i]})
                for i, (t, n) in enumerate(SCRIPTS["paged"][:5])]
        for fut in futs:
            fut.result(timeout=TIMEOUT)
        for t in workers:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        eng.stop()
        eng.thread.join(timeout=30)
    n = threads * per_thread
    got = {k: rec.registry.get_sample_value(k) for k in (
        "serve_queue_depth", "serve_ttft_seconds_count",
        "serve_tpot_seconds_count")}
    assert got == {"serve_queue_depth": 0.0, "serve_ttft_seconds_count": n,
                   "serve_tpot_seconds_count": n * tokens}
    assert rec.registry.get_sample_value(
        "serve_requests_total", {"outcome": "ok"}) == n
    assert len(rec.host_samples["stream"]) == n
    assert errors == [] and censuses
    assert all(sum(c["buckets"].values()) == c["pages_in_use"]
               for c in censuses)
