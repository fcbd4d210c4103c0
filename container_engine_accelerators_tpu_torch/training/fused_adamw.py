"""AdamW with global-norm clipping folded in: the JAX package's
`fused_adamw`, as a torch.optim.Optimizer.

Semantics, each as in the JAX version (which mirrors optax's
`chain(clip_by_global_norm(c), adamw(schedule, b1, b2, eps, wd))`):
  - `gnorm` is the global norm of the raw gradients, kept on the
    optimizer (a 0-d device tensor) for the step's metrics;
  - the clip is a select, scale = 1 if gnorm < c else c / gnorm, and it
    folds into the moment updates;
  - lr = schedule(count) with the count before the increment, and the
    bias corrections use count + 1;
  - m' = b1 * m + (1 - b1) * g, v' = b2 * v + (1 - b2) * g^2 (g scaled);
    with mu_dtype=bf16 the product b1 * m rounds in bf16, as it does
    when JAX multiplies a bf16 array by a Python float;
  - u = m'/bc1 / (sqrt(v'/bc2) + eps) + wd * p, and p += (-lr * u) cast
    to p.dtype.
The count and the schedule live on the host, so a step never waits for
the device. Each parameter is updated on its own, so the temporaries are
a few times the largest parameter, never the whole model.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


class FusedAdamW(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.Tensor],
                 lr: float | Callable[[int], float] = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 grad_clip: float | None = None,
                 mu_dtype: torch.dtype | None = None):
        self.schedule = lr if callable(lr) else (lambda _: lr)
        self.count = 0
        self.gnorm: torch.Tensor | None = None
        defaults = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        grad_clip=grad_clip, mu_dtype=mu_dtype)
        super().__init__(params, defaults)

    def _state(self, p: torch.Tensor, mu_dtype) -> dict:
        state = self.state[p]
        if not state:
            state["mu"] = torch.zeros_like(p, dtype=mu_dtype or p.dtype)
            state["nu"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        if not params:
            return None
        norms = torch._foreach_norm([p.grad for p in params])
        self.gnorm = torch.linalg.vector_norm(torch.stack(norms))
        lr = float(self.schedule(self.count))
        self.count += 1
        for group in self.param_groups:
            b1, b2, clip = group["b1"], group["b2"], group["grad_clip"]
            # In f32, as the JAX version computes them.
            bc1 = float(1 - np.float32(b1) ** np.float32(self.count))
            bc2 = float(1 - np.float32(b2) ** np.float32(self.count))
            if clip is None:
                scale = torch.ones((), device=self.gnorm.device)
            else:
                scale = torch.where(self.gnorm < clip,
                                    torch.ones_like(self.gnorm),
                                    clip / self.gnorm)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p, group["mu_dtype"])
                mu, nu = state["mu"], state["nu"]
                g = p.grad.float() * scale
                if mu.dtype == torch.float32:
                    m_new = mu * b1
                else:   # rounds in mu's dtype, b1 too, as JAX does
                    m_new = (mu * torch.tensor(b1, dtype=mu.dtype)).float()
                m_new.add_(g, alpha=1.0 - b1)
                v_new = (nu * b2).addcmul_(g, g, value=1.0 - b2)
                del g
                denom = (v_new / bc2).sqrt_().add_(group["eps"])
                u = (m_new / bc1).div_(denom)
                del denom
                u.add_(p.float(), alpha=group["weight_decay"])
                p.add_((u * -lr).to(p.dtype))
                mu.copy_(m_new)
                nu.copy_(v_new)
        return None


def grad_norm_metric(optimizer, grads: Iterable[torch.Tensor]
                     ) -> torch.Tensor:
    """The train step's grad_norm: the norm a FusedAdamW already holds,
    or a fresh global norm of `grads` for any other optimizer."""
    if isinstance(optimizer, FusedAdamW) and optimizer.gnorm is not None:
        return optimizer.gnorm
    grads = [g for g in grads if g is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
