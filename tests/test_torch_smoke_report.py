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
