"""RMSNorm with f32 statistics, cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x_f = x.float()
    var = x_f.square().mean(dim=-1, keepdim=True)
    normed = x_f * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
