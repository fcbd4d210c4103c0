"""Int8 weight quantization for the decode path.

  qw = quantize_weights(w)              # [..., D, F] -> int8 + f32 [..., F]
  y = int8_matmul(x, qw)                # [T, D] @ [D, F] -> [T, F] x.dtype
  qmodel = quantize_llama_params(model) # every projection and the lm_head

Symmetric per-output-channel int8 (scale = absmax / 127 over the
contraction dim), bit-identical to the JAX package's quantizer. Decoding
at small batch streams every weight once per step, so int8 storage
halves the bytes of the bf16 weight stream; `int8_matmul` dispatches on
the device: CUDA launches kernels/int8_matmul.cu (dequant in registers),
CPU runs `int8_matmul_plain`. The KV-cache quantizers come with the
int8/int4 KV modes in a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from container_engine_accelerators_tpu_torch import kernels

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_COLS_PER_BLOCK = 512      # kernels/int8_matmul.cu: 128 threads x 4
_ROWS_PER_BLOCK = 8


class QuantWeight(nn.Module):
    """int8 `values` (the source weight's shape) and f32 per-output-
    channel `scales` (its last dim). A module, so it can stand where a
    weight Parameter stood and moves with `.to(device)`."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        if values.dtype != torch.int8 or scales.dtype != torch.float32:
            raise TypeError("QuantWeight wants int8 values, f32 scales")
        self.register_buffer("values", values)
        self.register_buffer("scales", scales)

    @property
    def shape(self) -> torch.Size:
        return self.values.shape


def quantize_weights(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8, absmax reduced over axis -2
    only (stacked [L, D, F] weights get per-(layer, channel) scales)."""
    w_f = w.float()
    absmax = w_f.abs().amax(dim=-2, keepdim=True)
    scales = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w_f / scales), -127, 127).to(torch.int8)
    return QuantWeight(q, scales.squeeze(-2))


def dequantize(qw: QuantWeight, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    return (qw.values.float() * qw.scales[..., None, :]).to(dtype)


def _check(x: torch.Tensor, qw: QuantWeight):
    if x.ndim != 2 or qw.values.ndim != 2:
        raise ValueError(f"want x [T, D] and weight [D, F], got "
                         f"{tuple(x.shape)}, {tuple(qw.values.shape)}")
    if x.shape[1] != qw.values.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not contract with "
                         f"weight {tuple(qw.values.shape)}")


def int8_matmul_plain(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """(x @ q) * s with an f32 sum, in x.dtype: the kernel's function in
    plain PyTorch. int8 values are exact in bf16 and f32, so this is the
    TPU kernel's bf16(q) product to the order of summation."""
    _check(x, qw)
    acc = x.float() @ qw.values.float()
    return (acc * qw.scales).to(x.dtype)


def _splits(t: int, d: int, f: int, sms: int) -> tuple[int, int]:
    """(splits, d_per_split): enough blocks along the contraction dim to
    put ~2 blocks on each of the card's `sms` SMs when the output alone
    gives too few."""
    blocks = (-(-f // _COLS_PER_BLOCK)) * (-(-t // _ROWS_PER_BLOCK))
    splits = max(1, min(-(-2 * sms // blocks), d // 128))
    d_per_split = -(-d // splits)
    return -(-d // d_per_split), d_per_split


def int8_matmul_cuda(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """Launch kernels/int8_matmul.cu on CUDA tensors."""
    _check(x, qw)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int8_matmul kernel takes bf16 or f32 x, "
                        f"got {x.dtype}")
    w, s = qw.values, qw.scales
    if w.device != x.device or s.device != x.device:
        raise ValueError("x and the QuantWeight must share a device")
    if not (w.is_contiguous() and s.is_contiguous()):
        raise ValueError("int8_matmul kernel takes a contiguous weight")
    t, d = x.shape
    f = w.shape[1]
    if f % 4 or w.data_ptr() % 4:
        raise ValueError("int8_matmul kernel takes F % 4 == 0 and a "
                         f"4-byte aligned weight, got F={f}")
    x = x.contiguous()
    splits, d_per_split = _splits(t, d, f, kernels.sm_count(x.device))
    partial = torch.empty((splits, t, f), dtype=torch.float32,
                          device=x.device)
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    lib = kernels.load()
    err = lib.int8_matmul(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), partial.data_ptr(),
        y.data_ptr(), int(x.dtype == torch.bfloat16), t, d, f, d_per_split,
        splits, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check("int8_matmul", err)
    return y


def int8_matmul(x: torch.Tensor, qw: QuantWeight) -> torch.Tensor:
    """x [T, D] (bf16 or f32) @ int8 weight [D, F] -> [T, F] in x.dtype."""
    if x.device.type == "cuda":
        return int8_matmul_cuda(x, qw)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qw)
    raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")


def quantize_llama_params(model):
    """A copy of a models.llama.Llama whose projections and lm_head are
    QuantWeights; norms and the embedding are shared with `model`."""
    from container_engine_accelerators_tpu_torch.models.llama import (
        Llama,
        LlamaLayer,
    )

    layers = []
    for layer in model.layers:
        weights = {name: getattr(layer, name)
                   for name in LlamaLayer.WEIGHTS}
        weights.update({name: quantize_weights(weights[name])
                        for name in QUANT_KEYS})
        layers.append(LlamaLayer(**weights))
    return Llama(model.cfg, embed=model.embed, layers=layers,
                 final_norm=model.final_norm,
                 lm_head=quantize_weights(model.lm_head))
