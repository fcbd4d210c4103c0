"""chip_smoke.py's report of which decode-attention body a K1/K3 call
runs, and that body's registers and spill bytes, read from ptxas's -v
output in the kernel library's build log. The card runs of the smoke
gate on these numbers (the prefill body must not spill), so the report
is held here against a build log written in ptxas's format, with every
instantiation of both bodies in it."""

import itertools

import pytest

import chip_smoke
from container_engine_accelerators_tpu_torch import kernels

BODIES = ("decode_split_kernel", "prefill_mma_kernel")
PAYLOADS = ("Bf16", "Int8", "Int4")
KEYS = ("Contiguous", "Paged")
HEAD_DIMS = (32, 64, 128)


def _mangled(body: str, payload: str, d: int, keys: str) -> str:
    """The Itanium name nvcc gives an instantiation in the file's
    anonymous namespace."""
    ns = "_GLOBAL__N__51b7076f_19_decode_attention_cu_95940b72"
    return (f"_ZN{len(ns)}{ns}{len(body)}{body}INS_{len(payload) + 7}"
            f"{payload}PayloadELi{d}ENS_{len(keys) + 4}{keys}KeysEEEvPK13"
            "__nv_bfloat16PKvS6_PKfS8_PKiPS0_iiiifS2_")


def _build_log(path):
    """A build log with every instantiation, each with its own register
    count and, but for head_dim 128, spill bytes; returns the counts."""
    counts, lines = {}, ["== decode_attention.cu (rc 0)"]
    for i, (body, payload, d, keys) in enumerate(itertools.product(
            BODIES, PAYLOADS, HEAD_DIMS, KEYS)):
        name = _mangled(body, payload, d, keys)
        regs, spill = 64 + i, 0 if d == 128 else 8 * (i + 1)
        counts[body, payload, d, keys] = regs
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            "416 bytes cmem[0]"]
    path.write_text("\n".join(lines) + "\n")
    return counts


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("t,body,splits", [
    (1, "decode_split_kernel", 9),     # 4 rows a KV head: decode
    (2, "prefill_mma_kernel", 1),      # 8 rows: the prefill body
    (512, "prefill_mma_kernel", 1),
])
def test_decode_kernel_info_names_the_body_that_runs(monkeypatch, tmp_path,
                                                     payload, keys, t, body,
                                                     splits):
    log = tmp_path / "libport_kernels-0.log"
    counts = _build_log(log)
    monkeypatch.setattr(kernels, "build_log", lambda: log)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    info = chip_smoke.decode_kernel_info(None, "cuda", payload, keys, t, 8,
                                         32, 8, 2048)
    assert info == {"kernel": body, "splits": splits,
                    "registers": counts[body, payload, 128, keys],
                    "spill_bytes": 0}


def _k2_build_log(path):
    """A build log with every instantiation of kernels/int8_matmul.cu's
    two bodies, each with its own register count; returns the counts."""
    ns = "_GLOBAL__N__783171d2_14_int8_matmul_cu_03ece3dc"
    names = {("int8_wgmma_kernel", 128, "bf16"):
             f"_ZN47{ns}17int8_wgmma_kernelEPK13__nv_bfloat16PKaPKfPS0_PfPiiiii"}
    for nt in (8, 16, 32, 64, 128):
        names["int8_mma_kernel", nt, "bf16"] = (
            f"_ZN47{ns}15int8_mma_kernelILi{nt}E13__nv_bfloat16EEvPKT0_PKaPKf"
            "PS2_PfPiiiiii")
        names["int8_mma_kernel", nt, "f32"] = (
            f"_ZN47{ns}15int8_mma_kernelILi{nt}EfEEvPKT0_PKaPKfPS1_PfPiiiiii")
    counts, lines = {}, ["== int8_matmul.cu (rc 0)"]
    for i, (key, name) in enumerate(sorted(names.items())):
        counts[key] = 90 + i
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            f"ptxas info    : Used {90 + i} registers, used 1 barriers, "
            "128 bytes smem"]
    path.write_text("\n".join(lines) + "\n")
    return counts


@pytest.mark.parametrize("t,d,f,kind,body,tokens,splits", [
    (8, 4096, 14336, "bf16", "int8_mma_kernel", 8, 5),    # decode
    (8, 4096, 1024, "bf16", "int8_mma_kernel", 8, 32),
    (8, 4096, 128256, "f32", "int8_mma_kernel", 8, 1),    # the lm_head
    (16, 4096, 4096, "bf16", "int8_mma_kernel", 16, 16),
    (1024, 4096, 14336, "bf16", "int8_wgmma_kernel", 128, 1),   # prefill
    (1024, 4096, 1024, "bf16", "int8_wgmma_kernel", 128, 4),
    (1024, 4096, 128256, "f32", "int8_mma_kernel", 128, 1),
])
def test_k2_kernel_info_names_the_body_that_runs(monkeypatch, tmp_path, t, d,
                                                 f, kind, body, tokens,
                                                 splits):
    log = tmp_path / "libport_kernels-0.log"
    counts = _k2_build_log(log)
    monkeypatch.setattr(kernels, "build_log", lambda: log)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    info = chip_smoke.k2_kernel_info("cuda", t, d, f, kind)
    assert info == {"kernel": body, "tokens": tokens, "splits": splits,
                    "registers": counts[body, tokens, kind],
                    "spill_bytes": 0, "ptxas_serialized_wgmma": False}


def test_k2_ms_sums_both_bodies_and_the_older_kernels():
    # A prefill runs the wgmma body for bf16 x and the mma.sync body for
    # the f32 lm_head; an older checkout's K2 was int8_matmul_partial and
    # int8_matmul_finish. Every other kernel is left out.
    profile = {"kernels": {
        "(anonymous namespace)::int8_wgmma_kernel(CUtensorMap_st, CUt": 29.5,
        "void (anonymous namespace)::int8_mma_kernel<128, float>(floa": 7.75,
        "void (anonymous namespace)::int8_matmul_partial<__nv_bfloat1": 0.5,
        "void (anonymous namespace)::int8_matmul_finish<__nv_bfloat16": 0.25,
        "nvjet_tst_320x128_64x3_1x4_h_bz_coopB_NNT": 10.0,
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_": 3.0,
    }}
    assert chip_smoke.k2_ms(profile) == 38.0
    assert chip_smoke.k2_ms({"kernels": None}) is None


def _dump(order_by_rid: dict) -> dict:
    events = [{"name": "process_name", "ph": "M"}]
    for rid, names in order_by_rid.items():
        for name in names:
            events.append({"name": name, "cat": "req", "ph": "b",
                           "id": str(rid)})
            events.append({"name": name, "cat": "req", "ph": "e",
                           "id": str(rid)})
        events.append({"name": "request", "cat": "serve", "ph": "b",
                       "id": str(rid)})
    return {"traceEvents": events}


def test_observe_span_check_reads_the_trace_dump():
    # The observe phase's trace check: every traced request's first
    # queue, prefill, prefill_chunk, fetch and stream begins in that
    # order (admission's lookup and allocation spans may come between),
    # and every request traced.
    good = ["req/queue", "req/prefix_lookup", "req/page_alloc",
            "req/prefill", "req/prefill_chunk", "req/prefill_chunk",
            "req/fetch", "req/stream", "req/fetch", "req/stream"]
    assert chip_smoke._spans_in_order(_dump({1: good, 2: good}), 2) == 2
    with pytest.raises(chip_smoke.SmokeFailure, match="out of order"):
        chip_smoke._spans_in_order(
            _dump({1: good, 2: ["req/queue", "req/prefill", "req/fetch",
                                "req/prefill_chunk", "req/stream"]}), 2)
    with pytest.raises(chip_smoke.SmokeFailure, match="out of order"):
        chip_smoke._spans_in_order(_dump({1: good[:-3]}), 1)
    with pytest.raises(chip_smoke.SmokeFailure, match="traced requests"):
        chip_smoke._spans_in_order(_dump({1: good}), 2)


def test_observe_scrape_keys_samples_by_labels():
    text = ('# TYPE serve_requests counter\n'
            'serve_requests_total{outcome="ok"} 64.0\n'
            '# TYPE serve_ttft_seconds histogram\n'
            'serve_ttft_seconds_bucket{le="+Inf"} 64.0\n'
            'serve_ttft_seconds_count 64.0\n'
            'serve_ttft_seconds_sum 12.5\n')
    got = chip_smoke._scrape(text)
    assert got["serve_requests_total{outcome=ok}"] == 64.0
    assert got["serve_ttft_seconds_count"] == 64.0
    assert got["serve_ttft_seconds_bucket{le=+Inf}"] == 64.0


def test_divergence_rule_allows_only_near_ties():
    # The spec and pools phases' token check: each row's first
    # divergence from the plain run must sit at a top-two margin within
    # 2 D; later tokens are not compared (the contexts differ there).
    prompts = [[1, 2], [3, 4], [5, 6]]
    plain = [[1, 2, 7, 8, 9], [3, 4, 7, 8, 9], [5, 6, 7, 8, 9]]
    margins = [[0.5, 0.01, 0.5], [0.5, 0.5, 0.5], [0.03, 0.5, 0.5]]
    got = [[1, 2, 7, 0, 0], [3, 4, 7, 8, 9], [5, 6, 0, 8, 9]]
    rule = chip_smoke.divergence_rule(plain, got, prompts, margins, 0.02,
                                      "t")
    assert rule["divergences"] == 2 and rule["two_D"] == 0.04
    assert rule["diverged_at"] == [{"row": 0, "token": 1, "margin": 0.01},
                                   {"row": 2, "token": 0, "margin": 0.03}]
    with pytest.raises(chip_smoke.SmokeFailure, match="exceeds 2 D"):
        chip_smoke.divergence_rule(plain, got, prompts, margins, 0.01, "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="malformed"):
        chip_smoke.divergence_rule(plain, [[9, 2, 7, 8, 9]] * 3, prompts,
                                   margins, 1.0, "t")


def test_pattern_prompts_repeat_a_seeded_pattern():
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.llama import (
        llama_tiny,
    )

    a = chip_smoke._pattern_prompts(np, llama_tiny(), 3, 4)
    assert a == chip_smoke._pattern_prompts(np, llama_tiny(), 3, 4)
    assert len(a) == 4 and all(len(p) == 128 for p in a)
    assert all(p[16:32] == p[:16] == p[112:] for p in a)
    assert len({tuple(p[:16]) for p in a}) == 4
