"""Build, binding and launch counts of the port's hand-written CUDA
kernels.

`load()` compiles every `*.cu` file beside this module with nvcc for
`sm_90a` (one nvcc process per source, all started together; the `*.cuh`
headers beside them are included by those that need them), links the
objects into ONE shared library with a plain C interface, and loads it
with ctypes. Sources without PyTorch's headers build in seconds, where a
`torch.utils.cpp_extension` build takes minutes. The library lands in
`.torch_kernels_build/` at the repository root (listed in .gitignore),
named by a hash of the sources, headers and flags, so a checkout builds
once and an edited source rebuilds; the compiler's report lies beside it
under the same name (`build_log()`). A failed build raises.

Every wrapper calls `count(name)` right after it launches its kernel and
nowhere else, so a run can show that its main path went through the
kernels: `reset_launches()` before, `launches` after.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / ".torch_kernels_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              *ARCH_FLAGS]

launches: collections.Counter = collections.Counter()
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None
# The last build() in this process: its library, whether it compiled or
# found the library already built, and its seconds (build_record()).
_last_build: dict | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_DECODE_TAIL = [ctypes.c_float, _I, _P, _P, _P]
_SIGNATURES = {
    # Decode attention: each entry ends in (scale, splits, part, tickets,
    # stream); see ops/decode_attention.py.
    # (q, k, v, lens, out, B, T, Hq, Hkv, D, max_len, ...)
    "decode_attention_bf16": [_P] * 5 + [_I] * 6 + _DECODE_TAIL,
    # (q, k_pool, v_pool, lens, tables, out, B, T, Hq, Hkv, D, page,
    #  max_pages, n_pages, ...)
    "paged_decode_attention_bf16": [_P] * 6 + [_I] * 8 + _DECODE_TAIL,
    # (q, k, v, k_scales, v_scales, lens, out, B, T, Hq, Hkv, D, max_len,
    #  ...)
    **{f"decode_attention_{mode}": [_P] * 7 + [_I] * 6 + _DECODE_TAIL
       for mode in ("int8", "int4")},
    # (q, k_pool, v_pool, k_scales, v_scales, lens, tables, out, B, T, Hq,
    #  Hkv, D, page, max_pages, n_pages, ...)
    **{f"paged_decode_attention_{mode}": [_P] * 8 + [_I] * 8 + _DECODE_TAIL
       for mode in ("int8", "int4")},
    # (x, w, scales, y, part, tickets, x_is_bf16, T, D, F, body, tokens,
    #  d_per_split, splits, vec, stream); see ops/quant.plan.
    "int8_matmul": [_P] * 6 + [_I] * 9 + [_P],
    # (q, k, v, seg, out, lse, B, S, Hq, Hkv, D, causal, stream)
    "flash_fwd_bf16": [_P] * 6 + [_I] * 6 + [_P],
    # (q, k, v, seg, do, lse, delta, dq, B, S, Hq, Hkv, D, causal, stream)
    "flash_bwd_dq_bf16": [_P] * 8 + [_I] * 6 + [_P],
    # (q, k, v, seg, do, lse, delta, dk, dv, B, S, Hq, Hkv, D, causal,
    #  stream)
    "flash_bwd_dkv_bf16": [_P] * 9 + [_I] * 6 + [_P],
    # (x, out, n, stream)
    "scale_demo_f32": [_P, _P, ctypes.c_longlong, _P],
}


def count(name: str) -> None:
    with _lock:
        launches[name] += 1


def reset_launches() -> None:
    with _lock:
        launches.clear()


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM,
    114 on the PCIe card); sizes int8_matmul's split of D
    (ops/quant.plan) and decode attention's key-range split
    (ops/decode_attention.split_plan)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (PATH, or {home}/bin); the CUDA kernels "
            "cannot be built")
    return path


def build() -> Path:
    """Compile the sources (in parallel) and link them into one shared
    library; returns its path. The compiler's output, register and
    shared-memory reports included, goes to a `.log` of the same name
    beside it."""
    global _last_build
    t0 = time.perf_counter()
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):   # the headers too
        h.update(src.name.encode() + src.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libport_kernels-{digest}.so"
    if lib_path.exists():
        _last_build = {"library": str(lib_path), "compiled": False,
                       "seconds": time.perf_counter() - t0}
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}-{os.getpid()}"
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    lib_path.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = BUILD_DIR / f"libport_kernels-{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)   # atomic: a concurrent loader sees all or none
    _last_build = {"library": str(lib_path), "compiled": True,
                   "seconds": time.perf_counter() - t0}
    return lib_path


def build_record() -> dict:
    """The kernel library this process built or found (`build()`): its
    path, whether it was compiled here, the seconds that took, and
    whether it is loaded; no library before the first build."""
    rec = dict(_last_build) if _last_build else {
        "library": None, "compiled": False, "seconds": None}
    rec["loaded"] = _lib is not None
    return rec


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            _lib_path = build()
            lib = ctypes.CDLL(str(_lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.port_kernels_error_string.argtypes = [ctypes.c_int]
            lib.port_kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def build_log() -> Path:
    """The compiler's output for the library that `load()` loaded."""
    load()
    return _lib_path.with_suffix(".log")


def check(name: str, err: int) -> None:
    """Raise if a launch was refused (the C entry points return
    cudaGetLastError() right after the launch); else count it."""
    if err:
        msg = load().port_kernels_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    count(name)
