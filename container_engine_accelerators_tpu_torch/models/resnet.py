"""ResNet (v1.5) image classifier: the port of the JAX package's
models/resnet.py, the vision training family of the demo Jobs
demo/tpu-training/{resnet,mnist}-tpu.yaml.

The same network and numerics as the JAX package's:
- `apply` takes NHWC images, as the JAX package's does; inside, the
  activations are NCHW-logical tensors in `torch.channels_last` (NHWC in
  memory, the layout cuDNN's tensor-core convolutions take), and the
  convolution weights are OIHW f32 masters in channels_last, cast to the
  compute dtype (bf16 by default) for each convolution;
- padding is XLA's "SAME": total = max((ceil(in/s) - 1) * s + k - in, 0),
  total // 2 before and the rest after. Under stride 2 that is
  asymmetric ((0, 1) for a 3x3 on an even input, (2, 3) for the 7x7 stem
  on 224), so strided convolutions and the stem's 3x3/2 max pool pad
  explicitly (F.pad) and then run unpadded; PyTorch's own padding would
  shift the window by one pixel with the same output shape;
- batch norm as the JAX package writes it, not as nn.BatchNorm2d does:
  the batch mean and biased variance in f32 over (N, H, W), running
  statistics `m * old + (1 - m) * new` with m = 0.9 (biased variance
  kept), and the normalisation applied as `x * scale + shift` in the
  compute dtype;
- the global average pool and the fc layer in f32.

Parameter and buffer names follow the JAX tree: `stem.conv`,
`stem.bn.scale`, `stem.bn.mean`, `stages.<s>.<b>.convs.<i>.conv`,
`stages.<s>.<b>.proj.conv`, `fc.w`, `fc.b`
(interop.resnet_variables_from_jax maps the tree onto them).
Convolutions are F.conv2d: the JAX package runs them through
lax.conv_general_dilated, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)   # ResNet-50
    bottleneck: bool = True
    width: int = 64
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    stem_pool: bool = True              # 7x7/2 stem + 3x3/2 maxpool

    @property
    def block_expansion(self) -> int:
        return 4 if self.bottleneck else 1


def resnet50(**overrides) -> ResNetConfig:
    return ResNetConfig(**overrides)


def resnet18(**overrides) -> ResNetConfig:
    kw = dict(stage_sizes=(2, 2, 2, 2), bottleneck=False)
    kw.update(overrides)
    return ResNetConfig(**kw)


def resnet_tiny(**overrides) -> ResNetConfig:
    """CIFAR-scale config for tests and the demo: 2 stages, thin, no
    stem pool (32x32 inputs keep their spatial extent)."""
    kw = dict(stage_sizes=(1, 1), bottleneck=False, width=16,
              num_classes=10, stem_pool=False)
    kw.update(overrides)
    return ResNetConfig(**kw)


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _same_pad(x: torch.Tensor, k: int, stride: int,
              value: float = 0.0) -> torch.Tensor:
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, stride),
                                    same_pads(x.shape[3], k, stride))
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value).contiguous(
        memory_format=torch.channels_last)


class BatchNorm(nn.Module):
    """The JAX package's functional batch norm with its running
    statistics as buffers (updated in place by a training forward)."""

    def __init__(self, c: int, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.scale = nn.Parameter(torch.ones(c, dtype=cfg.param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=cfg.param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        cfg = self.cfg
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            m = cfg.bn_momentum
            with torch.no_grad():
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + cfg.bn_eps)
        s = self.scale.float()
        scale = (s * inv).to(x.dtype)
        shift = (self.bias.float() - mean * s * inv).to(x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]


class ConvBN(nn.Module):
    """conv (OIHW f32 master, channels_last) -> batch norm -> relu?"""

    def __init__(self, gen: torch.Generator | None, kh: int, cin: int,
                 cout: int, stride: int, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg, self.k, self.stride = cfg, kh, stride
        w = torch.empty(cout, cin, kh, kh, dtype=cfg.param_dtype)
        if gen is not None:
            fan_in = kh * kh * cin
            w = (torch.randn(cout, cin, kh, kh, generator=gen,
                             device=gen.device)
                 * np.sqrt(2.0 / fan_in)).to(cfg.param_dtype)
        self.conv = nn.Parameter(w.to(device).contiguous(
            memory_format=torch.channels_last))
        self.bn = BatchNorm(cout, cfg, device)

    def forward(self, x: torch.Tensor, train: bool,
                relu: bool = True) -> torch.Tensor:
        w = self.conv.to(self.cfg.dtype)
        if self.stride == 1:
            # Odd k at stride 1: SAME is symmetric, k // 2 each side.
            x = F.conv2d(x, w, padding=self.k // 2)
        else:
            x = F.conv2d(_same_pad(x, self.k, self.stride), w,
                         stride=self.stride)
        x = self.bn(x, train)
        return torch.relu(x) if relu else x


class Block(nn.Module):
    def __init__(self, gen, cin: int, planes: int, stride: int,
                 cfg: ResNetConfig, device=None):
        super().__init__()
        cout = planes * cfg.block_expansion
        if cfg.bottleneck:
            shapes = [(1, cin, planes, 1), (3, planes, planes, stride),
                      (1, planes, cout, 1)]
        else:
            shapes = [(3, cin, planes, stride), (3, planes, cout, 1)]
        self.convs = nn.ModuleList(ConvBN(gen, k, ci, co, st, cfg, device)
                                   for k, ci, co, st in shapes)
        self.proj = (ConvBN(gen, 1, cin, cout, stride, cfg, device)
                     if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(h, train, relu=i < len(self.convs) - 1)
        residual = x if self.proj is None else self.proj(x, train,
                                                         relu=False)
        return torch.relu(h + residual)


class Linear(nn.Module):
    """fc: w [cin, classes] (the JAX layout, x @ w) and b, f32."""

    def __init__(self, gen, cin: int, n: int, cfg: ResNetConfig,
                 device=None):
        super().__init__()
        w = torch.empty(cin, n)
        if gen is not None:
            w = torch.randn(cin, n, generator=gen,
                            device=gen.device) * cin ** -0.5
        self.w = nn.Parameter(w.to(device, cfg.param_dtype))
        self.b = nn.Parameter(torch.zeros(n, dtype=cfg.param_dtype,
                                          device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.float() + self.b.float()


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBN(gen, 7 if cfg.stem_pool else 3, 3, cfg.width,
                           2 if cfg.stem_pool else 1, cfg, device)
        cin = cfg.width
        stages = []
        for si, n_blocks in enumerate(cfg.stage_sizes):
            planes = cfg.width * (2 ** si)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Block(gen, cin, planes, stride, cfg, device))
                cin = planes * cfg.block_expansion
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        self.fc = Linear(gen, cin, cfg.num_classes, cfg, device)

    def forward(self, images: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """images [B, H, W, 3] (any float dtype) -> logits [B, classes]
        f32."""
        cfg = self.cfg
        # NHWC in memory is NCHW-logical in channels_last.
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        x = self.stem(x, train)
        if cfg.stem_pool:
            low = (-torch.inf if x.dtype == torch.float32
                   else torch.finfo(x.dtype).min)
            x = F.max_pool2d(_same_pad(x, 3, 2, low), 3, 2)
        for stage in self.stages:
            for block in stage:
                x = block(x, train)
        return self.fc(x.float().mean(dim=(2, 3)))   # global avg pool


def init_variables(gen: torch.Generator, cfg: ResNetConfig,
                   device: str | torch.device | None = None) -> ResNet:
    """A ResNet with He-normal convolutions, unit BN scales, zero biases
    and the JAX package's fresh statistics (mean 0, var 1), drawn from
    `gen` (the JAX package draws from jax.random, so parity goes through
    interop.resnet_variables_from_jax)."""
    return ResNet(cfg, gen, device or gen.device)


def apply(model: ResNet, images: torch.Tensor,
          train: bool = False) -> tuple[torch.Tensor, dict]:
    """(logits [B, classes] f32, batch_stats): the JAX package's apply on
    a module. In train mode the running statistics update in place and
    come back as {buffer name: tensor}; in eval mode they pass through
    unchanged."""
    logits = model(images, train=train)
    return logits, dict(model.named_buffers())


def make_train_step(model: ResNet, optimizer: torch.optim.Optimizer):
    """`step(batch) -> metrics`: one training forward (batch statistics,
    running statistics updated), the mean softmax cross-entropy of the
    f32 logits, its backward and an optimizer step; batch = {'images',
    'labels'}, metrics = {'loss', 'accuracy'} (tensors on the device)."""

    def step(batch: dict) -> dict:
        logits = model(batch["images"], train=True)
        labels = batch["labels"].long()
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_optimizer(model: ResNet, lr: float) -> torch.optim.Optimizer:
    """Adam at optax's defaults (b1 0.9, b2 0.999, eps 1e-8): the update
    optax.adam computes."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train(steps: int = 60, batch_size: int = 16, hw: int = 32,
          lr: float = 3e-3, seed: int = 0, cfg: ResNetConfig | None = None,
          log_fn=None, device: str | torch.device | None = None) -> float:
    """The demo entry (mnist.train's convention): train the tiny variant
    on synthetic class patterns and return held-out accuracy; the demo
    Job asserts it > 0.5. Runs on the card unless `device` says
    otherwise; raises where CUDA is asked for and absent."""
    from container_engine_accelerators_tpu_torch.models.convert import (
        resolve_device,
    )

    dev = resolve_device(device or "cuda")
    cfg = cfg or resnet_tiny(dtype=torch.float32)
    model = init_variables(torch.Generator(device=dev).manual_seed(seed),
                           cfg, dev)
    step = make_train_step(model, make_optimizer(model, lr))
    for i, batch in enumerate(synthetic_images(cfg, batch_size, hw,
                                               num_batches=steps,
                                               seed=seed, device=dev)):
        metrics = step(batch)
        if log_fn and i % 20 == 0:
            log_fn(f"resnet step {i} loss {float(metrics['loss']):.4f}")
    batch = next(synthetic_images(cfg, 4 * batch_size, hw, num_batches=1,
                                  seed=seed + 1, device=dev))
    with torch.no_grad():
        logits, _ = apply(model, batch["images"], train=False)
    acc = float((logits.argmax(-1) == batch["labels"]).float().mean())
    if log_fn:
        log_fn(f"resnet final accuracy {acc:.3f}")
    return acc


def synthetic_images(cfg: ResNetConfig, batch_size: int, hw: int,
                     num_batches: int | None = None, seed: int = 0,
                     device: str | torch.device = "cpu") -> Iterator[dict]:
    """Class-conditional synthetic images (no egress), the JAX package's
    numpy draws: each class a fixed random spatial pattern (from a fixed
    seed, so differently-seeded train and eval streams describe one
    task), each sample its pattern plus noise. {'images' [B, hw, hw, 3]
    f32, 'labels' [B] int32} on `device`."""
    patterns = np.random.default_rng(0).normal(
        size=(cfg.num_classes, hw, hw, 3))
    rng = np.random.default_rng(seed)
    i = 0
    while num_batches is None or i < num_batches:
        labels = rng.integers(0, cfg.num_classes, size=batch_size)
        images = patterns[labels] + rng.normal(
            size=(batch_size, hw, hw, 3)) * 0.3
        yield {"images": torch.from_numpy(images.astype(np.float32)).to(
                   device),
               "labels": torch.from_numpy(labels.astype(np.int32)).to(
                   device)}
        i += 1
