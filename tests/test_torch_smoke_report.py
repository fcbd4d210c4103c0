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
