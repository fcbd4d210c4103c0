"""MNIST-scale MLP: the port of the JAX package's models/mnist.py, the
smoke workload of the demo Job demo/tpu-training/mnist-tpu.yaml (its
contract: accuracy > 0.9 after 200 steps).

Data is synthetic (no egress): class-conditional Gaussian blobs in 784-d,
drawn by the same numpy generators as the JAX package's, so the batches
are bit-equal. Training is Adam at optax's defaults (torch.optim.Adam
computes optax.adam's update) on the softmax cross-entropy of f32 logits.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

N_CLASSES = 10
INPUT_DIM = 784


def init_params(gen: torch.Generator, hidden: int = 256,
                device: str | torch.device | None = None) -> dict:
    """{w1, b1, w2, b2}, f32, scaled normal weights and zero biases (the
    JAX package's shapes and scales; its draws come from jax.random, so
    parity goes through interop.mnist_params_from_jax)."""
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device)

    params = {
        "w1": normal(INPUT_DIM, hidden) * INPUT_DIM ** -0.5,
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, N_CLASSES) * hidden ** -0.5,
        "b2": torch.zeros(N_CLASSES),
    }
    return {k: v.to(device or gen.device) for k, v in params.items()}


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def synthetic_mnist(batch_size: int, num_batches: int | None = None,
                    seed: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(x [B, 784] f32, y [B] int32) numpy batches, the JAX package's
    draws: class centres from a fixed seed (so train and eval streams
    with different `seed`s describe one task), then labels and noise
    from `seed`."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(1234).normal(
        size=(N_CLASSES, INPUT_DIM)).astype(np.float32)
    i = 0
    while num_batches is None or i < num_batches:
        y = rng.integers(0, N_CLASSES, size=batch_size)
        x = centers[y] + 0.5 * rng.normal(
            size=(batch_size, INPUT_DIM)).astype(np.float32)
        yield x.astype(np.float32), y.astype(np.int32)
        i += 1


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, on f32 logits."""
    return F.cross_entropy(forward(params, x).float(), y.long())


def train(steps: int = 100, batch_size: int = 128, lr: float = 1e-2,
          seed: int = 0, log_fn=None,
          device: str | torch.device | None = None) -> float:
    """Train and return the accuracy on a held-out synthetic batch. Runs
    on the card unless `device` says otherwise; raises where CUDA is
    asked for and absent."""
    from container_engine_accelerators_tpu_torch.models.convert import (
        resolve_device,
    )

    dev = resolve_device(device or "cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {k: v.requires_grad_() for k, v in init_params(gen).items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    for i, (x, y) in enumerate(synthetic_mnist(batch_size, steps, seed)):
        loss = loss_fn(params, torch.from_numpy(x).to(dev),
                       torch.from_numpy(y).to(dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_fn and i % 20 == 0:
            log_fn(f"mnist step {i} loss {float(loss):.4f}")

    x, y = next(synthetic_mnist(512, 1, seed + 1))
    with torch.no_grad():
        pred = forward(params, torch.from_numpy(x).to(dev)).argmax(-1)
    acc = float((pred.cpu().numpy() == y).mean())
    if log_fn:
        log_fn(f"mnist final accuracy {acc:.3f}")
    return acc
