"""Token-file datasets: a copy of the JAX package's flat binary token
format (uint16 when the vocabulary fits, else uint32, with a JSON
sidecar) and its deterministic, process-sharded batch sampling, without
the chaos stall hook. The files are interchangeable between the two
packages, and the same file and seed give the same batches."""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

MAGIC = "tpu-tokens-v1"


def write_token_file(tokens, path: str, vocab_size: int) -> None:
    dtype = np.uint16 if vocab_size <= (1 << 16) else np.uint32
    arr = np.asarray(tokens, dtype=dtype)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        arr.tofile(f)
    # The sidecar lands atomically after the tokens: a loader that sees
    # the .json can always map the tokens it describes.
    tmp = f"{path}.json.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"magic": MAGIC, "dtype": arr.dtype.name,
                   "count": int(arr.size), "vocab_size": vocab_size}, f)
    os.replace(tmp, path + ".json")


class TokenDataset:
    """Memory-mapped token array + window sampling."""

    def __init__(self, path: str):
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} file")
        self.vocab_size = int(meta["vocab_size"])
        self.tokens = np.memmap(path, dtype=np.dtype(meta["dtype"]),
                                mode="r", shape=(int(meta["count"]),))

    def num_windows(self, seq_len: int) -> int:
        # +1: targets are inputs shifted by one.
        return (len(self.tokens) - 1) // seq_len

    def window(self, idx: int, seq_len: int) -> tuple[np.ndarray, np.ndarray]:
        start = idx * seq_len
        chunk = np.asarray(self.tokens[start:start + seq_len + 1],
                           dtype=np.int32)
        return chunk[:-1], chunk[1:]


def token_file_batches(path: str, batch_size: int, seq_len: int,
                       process_id: int = 0, num_processes: int = 1,
                       seed: int = 0,
                       num_batches: int | None = None) -> Iterator[dict]:
    """Yield {'inputs','targets'} batches. Windows are shuffled once per
    pass with a shared seed, then dealt round-robin across processes, so
    every process sees a disjoint, deterministic stream."""
    ds = TokenDataset(path)
    n = ds.num_windows(seq_len)
    if n < batch_size * num_processes:
        raise ValueError(
            f"{path}: only {n} windows of {seq_len}; need at least "
            f"{batch_size * num_processes}")
    rng = np.random.default_rng(seed)
    produced = 0
    while num_batches is None or produced < num_batches:
        order = rng.permutation(n)
        mine = order[process_id::num_processes]
        for i in range(0, len(mine) - batch_size + 1, batch_size):
            if num_batches is not None and produced >= num_batches:
                return
            idxs = mine[i:i + batch_size]
            pairs = [ds.window(int(j), seq_len) for j in idxs]
            yield {
                "inputs": np.stack([p[0] for p in pairs]),
                "targets": np.stack([p[1] for p in pairs]),
            }
            produced += 1


def encode_bytes(text: str) -> np.ndarray:
    """Byte-level tokenizer (vocab 256), so text demos need no external
    tokenizer."""
    return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
        np.int32)
