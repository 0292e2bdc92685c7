"""Wide Residual Network on CIFAR-10.

Port of ``theanompi_tpu/models/wresnet.py`` — ``WResNet`` (Zagoruyko &
Komodakis 2016), the reference's small self-contained benchmark model.

WRN-d-k: depth d = 6n+4 with pre-activation residual blocks, widths
(16k, 32k, 64k) over three stages with strides (1, 2, 2).  Default
WRN-16-4.  The stride-2 3x3 'SAME' convs pad (0, 1) on 32 -> 16, the
lax convention ``ops.layers.Conv`` reproduces.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.data.cifar10 import (
    N_CLASSES,
    SHAPE,
    Cifar10Data,
)
from theanompi_tpu_torch.ops import initializers
from theanompi_tpu_torch.ops.layers import (
    BN,
    FC,
    Activation,
    Conv,
    GlobalAvgPool,
    Layer,
    Sequential,
)


class PreactBlock(Layer):
    """BN-ReLU-Conv pre-activation residual block (WRN style)."""

    def __init__(self, out_ch: int, stride: int = 1):
        super().__init__()
        self.out_ch = out_ch
        self.stride = stride
        self.bn1 = BN()
        self.conv1 = Conv(out_ch, 3, stride=stride, pad="SAME", bias=False)
        self.bn2 = BN()
        self.conv2 = Conv(out_ch, 3, stride=1, pad="SAME", bias=False)
        self.shortcut = None  # set in init if the shape changes

    def init(self, gen, in_shape):
        self.bn1.init(gen, in_shape)
        shape1 = self.conv1.init(gen, in_shape)
        self.bn2.init(gen, shape1)
        out_shape = self.conv2.init(gen, shape1)
        if self.stride != 1 or in_shape[-1] != self.out_ch:
            self.shortcut = Conv(self.out_ch, 1, stride=self.stride,
                                 pad="SAME", bias=False)
            self.shortcut.init(gen, in_shape)
        return out_shape

    def forward(self, x, train=False, gen=None):
        h = torch.relu(self.bn1(x, train))
        # preact shortcut: branch from the *activated* input when
        # projecting, from raw x otherwise (standard WRN wiring)
        sc = self.shortcut(h) if self.shortcut is not None else x
        h = self.conv1(h)
        h = torch.relu(self.bn2(h, train))
        return self.conv2(h) + sc


class WResNet(ClassifierModel):
    """WRN-{depth}-{widen} CIFAR-10 classifier under the model contract."""

    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("lr", 0.1)
        config.setdefault("weight_decay", 5e-4)
        config.setdefault("n_epochs", 60)
        config.setdefault("lr_schedule", {20: 0.02, 40: 0.004, 50: 0.0008})
        super().__init__(config, device)
        self.depth = int(config.get("depth", 16))
        self.widen = int(config.get("widen", 4))
        if (self.depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n+4, got {self.depth}")

    def build_model(self, n_replicas: int = 1) -> None:
        n = (self.depth - 4) // 6
        k = self.widen
        layers: list[Layer] = [
            Conv(16, 3, pad="SAME", bias=False, w_init=initializers.he())
        ]
        for width, stride in [(16 * k, 1), (32 * k, 2), (64 * k, 2)]:
            for b in range(n):
                layers.append(PreactBlock(width, stride if b == 0 else 1))
        layers += [BN(), Activation("relu"), GlobalAvgPool(), FC(N_CLASSES)]
        self.net = Sequential(layers)
        self.input_shape = SHAPE
        self.data = Cifar10Data(
            batch_size=self.config.get("batch_size", 128),
            n_replicas=n_replicas,
            seed=self.seed,
            n_train=self.config.get("n_train"),
            n_val=self.config.get("n_val"),
            label_noise=float(self.config.get("label_noise", 0.0)),
        )
        self._init_params()
