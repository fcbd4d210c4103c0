"""Provoke a real device-memory exhaustion from PyTorch's CUDA allocator.

Asks for one f32 buffer larger than the card's whole memory (the total
from torch.cuda.mem_get_info(), plus a GiB), as the JAX package's
demo/tpu-error/real-fault/provoke_hbm_oom.py asks XLA:TPU for more HBM
than the chip has. The allocator refuses with "CUDA out of memory. Tried
to allocate ..."; the script writes that error to stderr and exits
non-zero. That text is what the health checker's HBM_OOM rule is held
against (demo/real_fault/logs/hbm_oom.log).

  python -m container_engine_accelerators_tpu_torch.demo.real_fault.provoke_hbm_oom
"""

from __future__ import annotations

import sys

import torch

MARGIN_BYTES = 1 << 30


def main() -> int:
    if not torch.cuda.is_available():
        print("provoke_hbm_oom: no CUDA device", file=sys.stderr)
        return 2
    _, total = torch.cuda.mem_get_info()
    n = (total + MARGIN_BYTES) // 4
    try:
        x = torch.empty(n, dtype=torch.float32, device="cuda")
    except torch.OutOfMemoryError as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"allocated {x.numel() * 4} bytes on a card of {total}: no "
          "refusal provoked", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
