"""Fixtures shared by the CPU rehearsals of chip_smoke.py's phases
(tests/test_torch_smoke_*.py) and the port's heavier CPU tests: the
card's kernel entries pointed at their counted plain versions, a fake
card whose memory a real climb fills, and a cap on torch's threads."""

import pytest

from container_engine_accelerators_tpu_torch import kernels


@pytest.fixture
def two_torch_threads(monkeypatch):
    """Two intra-op threads for the test, and for the processes it
    starts. The suite runs as several workers on one host; a torch that
    spreads every op over all of the host's cores beside the other
    workers spends its time waiting on its own threads: the training
    rehearsal took 13.8 s alone, 597 s in a six-worker run of the whole
    suite, 362 s beside five workers, and 15.5 s beside them on two
    threads."""
    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def counted_kernels(monkeypatch):
    """The card's entries pointed at their plain versions, each counted
    as a launch, and the card-only calls stubbed: the smoke's training
    phases then run on the CPU as they run on the card."""
    import torch

    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.ops import (
        flash_attention as fa,
    )

    def counted(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            kernels.count(name)
            return out
        return wrapper

    monkeypatch.setattr(fa, "_route",
                        lambda x, plain: "plain" if plain else "cuda")
    monkeypatch.setitem(fa._FWD, "cuda",
                        counted("flash_fwd", fa.flash_fwd_plain))
    monkeypatch.setitem(fa._BWD_DQ, "cuda",
                        counted("flash_bwd_dq", fa.flash_bwd_dq_plain))
    monkeypatch.setitem(fa._BWD_DKV, "cuda",
                        counted("flash_bwd_dkv", fa.flash_bwd_dkv_plain))
    for name in ("decode_attention", "paged_decode_attention",
                 "int8_matmul"):
        monkeypatch.setattr(decode, name,
                            counted(name, getattr(decode, name)))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    from container_engine_accelerators_tpu_torch.models import llama
    return llama.llama_tiny(vocab_size=512, d_model=256, n_heads=2,
                            n_kv_heads=1, d_ff=256, max_seq_len=2048,
                            use_flash=True, remat_policy="dots")


class FakeCard:
    """An 80 GiB card whose memory the real climb's allocations fill:
    HbmPoller reads it, card_alloc takes from it and raises the CUDA
    out-of-memory error when it is full."""

    limit = 80 << 30

    def __init__(self):
        self.used = 20 << 30

    def stats(self):
        return [{"device": "cuda:0", "bytes_in_use": self.used,
                 "peak_bytes_in_use": self.used, "bytes_limit": self.limit}]

    def alloc(self, torch, dev, n_bytes):
        if self.used + n_bytes > self.limit:
            raise torch.cuda.OutOfMemoryError("fake card full")
        self.used += n_bytes
        card = self

        class Held:
            def __del__(self):
                card.used -= n_bytes

        return Held()
