"""Tensor ops of the port. Each op that holds a kernel dispatches on the
tensor's device: CUDA launches the kernel, CPU runs the plain PyTorch
version that sits beside it."""

from container_engine_accelerators_tpu_torch.ops.rmsnorm import rms_norm
from container_engine_accelerators_tpu_torch.ops.rope import (
    apply_rope,
    rope_frequencies,
)

__all__ = ["apply_rope", "rms_norm", "rope_frequencies"]
