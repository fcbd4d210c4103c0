"""The training step and loop on one device: the JAX package's
make_optimizer, loss_fn, make_train_step, train_loop and fit, without
the mesh, checkpoints and recorder (not ported yet).

PyTorch idiom where JAX donates and rebuilds: the step updates the
model's parameters and the optimizer's moments in place. The step count
lives on the host, and the loop reads the device only at log boundaries
(the loss fetch), as the JAX loop does. Host batches reach the card
through pinned, non-blocking copies.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.models import llama
from container_engine_accelerators_tpu_torch.models.convert import (
    resolve_device,
)
from container_engine_accelerators_tpu_torch.training.fused_adamw import (
    FusedAdamW,
    grad_norm_metric,
)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule's formula, on the host: a
    linear ramp from init to peak over warmup_steps, then a cosine from
    peak to end_value over the remaining decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay + alpha)

    return schedule


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0, warmup_steps: int = 100,
                   decay_steps: int = 10_000,
                   mu_dtype: torch.dtype | None = None
                   ) -> Callable[..., FusedAdamW]:
    """The training update rule: global-norm clip, then AdamW on a
    warmup-cosine schedule. Returns a factory: call it on the model's
    parameters to get the FusedAdamW (a torch optimizer is bound to its
    parameters; the JAX one is not)."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=warmup_steps, decay_steps=decay_steps,
        end_value=learning_rate * 0.1)
    return functools.partial(FusedAdamW, lr=schedule, b1=b1, b2=b2,
                             weight_decay=weight_decay, grad_clip=grad_clip,
                             mu_dtype=mu_dtype)


def loss_fn(model: llama.Llama, batch: dict, cfg: llama.LlamaConfig,
            plain: bool = False) -> torch.Tensor:
    """Next-token cross entropy in f32, averaged over the targets >= 0
    (negative targets are padding)."""
    logits = llama.forward(model, batch["inputs"], cfg, plain=plain)
    targets = batch["targets"].reshape(-1)
    mask = (targets >= 0).float()
    losses = F.cross_entropy(logits.view(-1, logits.shape[-1]),
                             targets.clamp(min=0).long(), reduction="none")
    return (losses * mask).sum() / mask.sum().clamp(min=1.0)


def make_train_step(cfg: llama.LlamaConfig, optimizer: torch.optim.Optimizer,
                    grad_accum: int = 1, plain: bool = False):
    """`step(model, batch) -> metrics`: loss and gradients, one optimizer
    update in place, and {'loss', 'grad_norm', 'tokens'} as device
    scalars (nothing waits for the device).

    `grad_accum > 1` splits the batch's leading dim into that many equal
    microbatches and averages their gradients before the one update.
    `plain=True` runs flash attention's plain versions (the on-card
    reference for the kernels)."""

    def step(model: llama.Llama, batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        rows = batch["inputs"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{grad_accum} microbatches")
        losses = []
        for i in range(grad_accum):
            mb = {key: x.chunk(grad_accum)[i] for key, x in batch.items()}
            loss = loss_fn(model, mb, cfg, plain=plain)
            (loss / grad_accum).backward()
            losses.append(loss.detach())
        optimizer.step()
        grads = [p.grad for p in model.parameters()]
        return {"loss": torch.stack(losses).mean(),
                "grad_norm": grad_norm_metric(optimizer, grads),
                "tokens": (batch["targets"] >= 0).sum()}

    return step


@dataclasses.dataclass
class TrainState:
    step: int                       # optimizer steps taken (host count)
    model: llama.Llama
    optimizer: torch.optim.Optimizer
    tokens: int = 0                 # targets trained on (host count)
    seconds: float = 0.0            # the loop's wall time, to its last fence


def to_device(batch: dict, device: torch.device) -> dict:
    """Host arrays as tensors on `device`; on the card through pinned
    memory without blocking, so the copy does not wait for queued work."""
    out = {}
    for key, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def train_loop(state: TrainState, batches: Iterator, step_fn,
               max_steps: int | None = None, log_every: int = 10,
               log_fn=print) -> tuple[TrainState, dict | None]:
    """Run `step_fn` over `batches` until they end or `state.step`
    reaches `max_steps`; returns the state and the last metrics. Every
    `log_every` steps (counted from this call's first) the loss and grad
    norm are fetched, the loop's only wait on the device, and logged."""
    device = state.model.device
    metrics = None
    it = iter(batches)
    t0 = time.perf_counter()
    i = 0
    while max_steps is None or state.step < max_steps:
        try:
            batch = next(it)
        except StopIteration:
            break
        state.tokens += int(np.sum(np.asarray(batch["targets"]) >= 0))
        metrics = step_fn(state.model, to_device(batch, device))
        state.step += 1
        if log_every and i % log_every == 0:
            loss, gnorm = torch.stack(
                [metrics["loss"], metrics["grad_norm"]]).tolist()
            log_fn(f"step {state.step} loss {loss:.4f} "
                   f"grad_norm {gnorm:.3f}")
        i += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    state.seconds += time.perf_counter() - t0
    return state, metrics


def fit(cfg: llama.LlamaConfig, optimizer: Callable[..., FusedAdamW],
        batches: Iterator, *, device: str | torch.device = "cuda",
        max_steps: int | None = None, seed: int = 0, log_every: int = 10,
        log_fn=print) -> tuple[TrainState, dict | None]:
    """Train a fresh model on one device: random masters from `seed`
    (init_train_params), `optimizer` (a make_optimizer factory) bound to
    them, then train_loop over `batches` up to `max_steps`. Runs on the
    card unless `device` says otherwise; asking for CUDA without it
    raises. Returns (state, last metrics)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = llama.init_train_params(cfg, gen, dev)
    opt = optimizer(model.parameters())
    state = TrainState(step=0, model=model, optimizer=opt)
    return train_loop(state, batches, make_train_step(cfg, opt),
                      max_steps=max_steps, log_every=log_every,
                      log_fn=log_fn)
