"""Concrete zoo members: ``flax_zoo``'s ``_CNN`` and pre-activation
``_ResNet18`` as ``torch.nn`` modules (port of
``theanompi_tpu/models/flax_zoo/cnn.py``).

``TorchCNN`` — the small conv net (the integration smoke model).
``TorchResNet18`` — pre-activation ResNet-18 at CIFAR scale.

The layers compute what linen's do, with linen's defaults:

- ``Conv``: 'SAME' padding as lax resolves it (the odd pad at the
  bottom and right), no bias; ``Dense``: ``x @ kernel + bias``.  Both
  run in ``promote_types(x.dtype, param dtype)``, linen's
  ``promote_dtype``: a bf16 batch meets fp32 parameters in fp32.
- ``BatchNorm``: statistics over every axis but the channel's in at
  least fp32, the variance ``max(0, E[x²] − E[x]²)`` (linen's
  ``use_fast_variance``), the running statistics ``m·old + (1 − m)·batch``
  (momentum 0.9, eps 1e-5), ``y = (x − mean)·(rsqrt(var + eps)·scale)
  + bias``.
- max-pool 2×2 stride 2 'VALID', a global mean over H and W, dropout
  with keep-probability scaling.

Submodules carry linen's auto-names (``Conv_0``, ``BatchNorm_0``,
``_ResBlock_3``, ``Dense_0``), so ``TorchLayer``'s key paths are the
flax tree's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from theanompi_tpu_torch.models.data.cifar10 import N_CLASSES
from theanompi_tpu_torch.models.torch_zoo.adapter import TorchClassifier
from theanompi_tpu_torch.ops.layers import same_pads


def _promote(x: torch.Tensor, *ps: torch.Tensor):
    dt = x.dtype
    for p in ps:
        dt = torch.promote_types(dt, p.dtype)
    return (x.to(dt),) + tuple(p.to(dt) for p in ps)


class Conv(nn.Conv2d):
    """linen ``Conv(features, kernel, strides, use_bias=False)``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, bias=False)

    def forward(self, x):
        (t, b), (lo, r) = same_pads(x.shape[2:], self.kernel_size,
                                    self.stride, "SAME")
        x, w = _promote(x, self.weight)
        return F.conv2d(F.pad(x, (lo, r, t, b)), w, None, self.stride)


class Dense(nn.Linear):
    """linen ``Dense(features)``."""

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.linear(x, w, b)


class BatchNorm(nn.Module):
    """linen ``BatchNorm(momentum=0.9)`` over NCHW-indexed ``x`` (see
    the module docstring)."""

    def __init__(self, ch: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = (0,) + tuple(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


def _pool(x):
    return F.max_pool2d(x, 2, 2)


class _CNN(nn.Module):
    """flax_zoo ``_CNN``: two conv–BN–relu–maxpool stages, a global mean,
    dropout 0.3 and a Dense head."""

    def __init__(self, n_classes: int = N_CLASSES, width: int = 32,
                 in_ch: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_ch, width, 3)
        self.BatchNorm_0 = BatchNorm(width)
        self.Conv_1 = Conv(width, 2 * width, 3)
        self.BatchNorm_1 = BatchNorm(2 * width)
        self.Dense_0 = Dense(2 * width, n_classes)

    def forward(self, x, train: bool = False):
        for conv, bn in ((self.Conv_0, self.BatchNorm_0),
                         (self.Conv_1, self.BatchNorm_1)):
            x = _pool(torch.relu(bn(conv(x), train)))
        x = F.dropout(x.mean((2, 3)), 0.3, training=train)
        return self.Dense_0(x)


class _ResBlock(nn.Module):
    """flax_zoo ``_ResBlock``: pre-activation, the 1×1 projection (from
    the activated input) when the stride or width changes.  linen names
    the convs in creation order, so the projection, when there is one,
    is ``Conv_0``."""

    def __init__(self, in_ch: int, ch: int, stride: int = 1):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.project = stride != 1 or in_ch != ch
        i = int(self.project)
        if self.project:
            self.Conv_0 = Conv(in_ch, ch, 1, stride)
        self.convs = (f"Conv_{i}", f"Conv_{i + 1}")
        self.add_module(self.convs[0], Conv(in_ch, ch, 3, stride))
        self.BatchNorm_1 = BatchNorm(ch)
        self.add_module(self.convs[1], Conv(ch, ch, 3))

    def forward(self, x, train: bool = False):
        h = torch.relu(self.BatchNorm_0(x, train))
        sc = self.Conv_0(h) if self.project else x
        h = getattr(self, self.convs[0])(h)
        h = torch.relu(self.BatchNorm_1(h, train))
        return getattr(self, self.convs[1])(h) + sc


class _ResNet18(nn.Module):
    """flax_zoo ``_ResNet18``: a 3×3 stem, four stages of pre-activation
    blocks (strides 1, 2, 2, 2), BN–relu, a global mean, a Dense head."""

    def __init__(self, n_classes: int = N_CLASSES,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 in_ch: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_ch, width, 3)
        self.blocks = []
        ch = width
        for i, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                name = f"_ResBlock_{len(self.blocks)}"
                out = width * 2 ** i
                self.add_module(name, _ResBlock(
                    ch, out, stride=2 if (i > 0 and b == 0) else 1))
                self.blocks.append(name)
                ch = out
        self.BatchNorm_0 = BatchNorm(ch)
        self.Dense_0 = Dense(ch, n_classes)

    def forward(self, x, train: bool = False):
        x = self.Conv_0(x)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = torch.relu(self.BatchNorm_0(x, train))
        return self.Dense_0(x.mean((2, 3)))


class TorchCNN(TorchClassifier):
    def module_factory(self, config: dict):
        return _CNN(width=int(config.get("width", 32)))


class TorchResNet18(TorchClassifier):
    def module_factory(self, config: dict):
        return _ResNet18(width=int(config.get("width", 64)))
