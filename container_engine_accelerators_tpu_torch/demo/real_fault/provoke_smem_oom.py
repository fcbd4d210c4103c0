"""Provoke a real shared-memory exhaustion from the CUDA toolchain.

Compiles K7 (kernels/scale_demo.cu) with -DK7_TILE_ROWS=4096: the whole
[4096, 4096] f32 array (64 MiB) as one tile of static shared memory, the
one block the Pallas kernel of the JAX package's
demo/tpu-error/real-fault/provoke_vmem_oom.py asked of the TPU's VMEM. A
block may hold 48 KiB of static shared memory, so the toolchain refuses
the build, as the TPU compiler refused the 128 MiB block. Its verbatim
output goes to stderr and the script exits non-zero; that text is what
the health checker's VMEM_OOM rule is held against
(demo/real_fault/logs/smem_oom.log).

  python -m container_engine_accelerators_tpu_torch.demo.real_fault.provoke_smem_oom

It builds into a directory of its own under the kernel build directory,
never into the kernel library, and needs nvcc but no card.
"""

from __future__ import annotations

import subprocess
import sys

from container_engine_accelerators_tpu_torch import kernels

TILE_ROWS = 4096          # the whole array: 4096 x 4096 f32 = 64 MiB
OUT_DIR = kernels.BUILD_DIR / "smem_oom"


def compile_oversized() -> subprocess.CompletedProcess:
    """nvcc on kernels/scale_demo.cu with a tile of TILE_ROWS rows;
    stdout and stderr together in `.stdout`."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DK7_TILE_ROWS={TILE_ROWS}",
         "-c", "scale_demo.cu", "-o", str(OUT_DIR / "scale_demo.o")],
        cwd=kernels.SRC_DIR, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=300)


def main() -> int:
    proc = compile_oversized()
    sys.stderr.write(proc.stdout)
    if proc.returncode == 0:
        print(f"K7 with a {TILE_ROWS}-row tile compiled: no refusal "
              "provoked", file=sys.stderr)
        return 0
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
