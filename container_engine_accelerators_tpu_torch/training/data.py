"""Synthetic LM data: a copy of the JAX package's `synthetic_batches`,
deterministic and host-side, with its chaos stall hook. For the same
arguments it yields the same arrays."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batches(vocab_size: int, batch_size: int, seq_len: int,
                      num_batches: int | None = None,
                      seed: int = 0) -> Iterator[dict]:
    """Yields {'inputs': [B,S] int32, 'targets': [B,S] int32} batches.

    Sequences follow x[t+1] = (a * x[t] + b) % vocab with per-sequence
    (a, b) and 10% uniform noise: learnable structure, nonzero floor.
    """
    from container_engine_accelerators_tpu_torch.training.dataset import (
        maybe_stall,
    )

    rng = np.random.default_rng(seed)
    i = 0
    while num_batches is None or i < num_batches:
        # An armed data-stall fault sleeps here, inside the iterator, so
        # the loop's data-wait clock sees a real loader stall.
        maybe_stall()
        a = rng.integers(1, min(vocab_size, 7), size=(batch_size, 1))
        b = rng.integers(0, vocab_size, size=(batch_size, 1))
        x0 = rng.integers(0, vocab_size, size=(batch_size, 1))
        seq = np.empty((batch_size, seq_len + 1), dtype=np.int64)
        seq[:, 0] = x0[:, 0]
        for step in range(1, seq_len + 1):
            seq[:, step] = (a[:, 0] * seq[:, step - 1] + b[:, 0]) % vocab_size
        noise = rng.random(seq.shape) < 0.1
        seq = np.where(noise, rng.integers(0, vocab_size, size=seq.shape), seq)
        yield {
            "inputs": seq[:, :-1].astype(np.int32),
            "targets": seq[:, 1:].astype(np.int32),
        }
        i += 1
