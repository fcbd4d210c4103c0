"""Model loading policy shared by the CLIs. This slice loads only the
random `llama_tiny`; checkpoints come with a later slice."""

from __future__ import annotations

import torch

from container_engine_accelerators_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    init_params,
    llama_tiny,
)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device to run on. Asking for CUDA where there is none
    raises: the port never drops to the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def load_model(seed: int = 0, device: str | torch.device = "cuda"
               ) -> tuple[Llama, LlamaConfig]:
    """A randomly initialised llama_tiny on `device`, from `seed`."""
    dev = resolve_device(device)
    cfg = llama_tiny()
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_params(cfg, gen, dev), cfg
