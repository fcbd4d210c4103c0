"""K7, the real-fault demo kernel: out = x * 2 on an f32 array.

The counterpart of the Pallas `kernel` in the JAX package's
demo/tpu-error/real-fault/provoke_vmem_oom.py. Its healthy build
(kernels/scale_demo.cu, a tile of 1 row x 4096 columns in static shared
memory) is held against `scale_demo_plain`; the same source built with
the whole array as one tile is the real fault that
demo/real_fault/provoke_smem_oom.py provokes.
"""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch import kernels


def scale_demo_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def scale_demo_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch kernels/scale_demo.cu on a CUDA f32 tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"scale_demo kernel takes a CUDA tensor, "
                         f"got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"scale_demo kernel takes f32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 16:
        raise ValueError("scale_demo kernel takes a 16-byte aligned x")
    err = kernels.load().scale_demo_f32(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check("scale_demo", err)
    return out


def scale_demo(x: torch.Tensor) -> torch.Tensor:
    """x * 2: the kernel on a CUDA tensor, the plain version on the CPU."""
    if x.device.type == "cuda":
        return scale_demo_cuda(x)
    if x.device.type == "cpu":
        return scale_demo_plain(x)
    raise ValueError(f"scale_demo runs on cuda or cpu, not {x.device}")
