"""ResNet-50 on ImageNet — the north-star benchmark model.

Port of ``theanompi_tpu/models/resnet50.py``: the v1.5 variant (stride
on the 3x3, not the 1x1), he init, the last BN scale of each block
zero-initialized, BN in fp32.  The stem's max pool is
``Pool(3, 2, pad="SAME")``: 112 -> 56 pads (0, 1), which is not
torchvision's ``padding=1``.

``stem_s2d`` is accepted: the JAX package's space-to-depth stem is a TPU
layout transform of the same convolution, which the plain strided conv
computes here.  ``stage1_width`` (the JAX package's retired
MXU-padding experiment: the stem and stage 1's internal convs at that
width, the residual stream at 256) builds the same network as JAX;
with zero pads it computes the 64-wide function.  It has no card
kernel of its own and no reason to be set on this card.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.data.imagenet import (
    CROP,
    N_CLASSES,
    ImageNetData,
)
from theanompi_tpu_torch.ops import initializers
from theanompi_tpu_torch.ops.layers import (
    BN,
    FC,
    Activation,
    Conv,
    GlobalAvgPool,
    Layer,
    Pool,
    Sequential,
)

# (blocks, channels) per stage
_STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
_EXPANSION = 4


class Bottleneck(Layer):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with projection shortcut;
    ``out_ch`` (default ``ch * 4``) decouples the output width from the
    internal one, for ``stage1_width``."""

    def __init__(self, ch: int, stride: int = 1, out_ch: int | None = None):
        super().__init__()
        self.ch = ch
        self.out_ch = out_ch if out_ch is not None else ch * _EXPANSION
        self.stride = stride
        self.conv1 = Conv(ch, 1, bias=False)
        self.bn1 = BN()
        self.conv2 = Conv(ch, 3, stride=stride, pad=1, bias=False)
        self.bn2 = BN()
        self.conv3 = Conv(self.out_ch, 1, bias=False)
        self.bn3 = BN()
        self.proj = None
        self.bn_proj = None

    def init(self, gen, in_shape):
        sh = self.conv1.init(gen, in_shape)
        self.bn1.init(gen, sh)
        sh = self.conv2.init(gen, sh)
        self.bn2.init(gen, sh)
        out = self.conv3.init(gen, sh)
        self.bn3.init(gen, out)
        # zero-init final BN scale: block starts as identity
        with torch.no_grad():
            self.bn3.scale.zero_()
        if self.stride != 1 or in_shape[-1] != out[-1]:
            self.proj = Conv(self.out_ch, 1, stride=self.stride, bias=False)
            self.bn_proj = BN()
            self.proj.init(gen, in_shape)
            self.bn_proj.init(gen, out)
        return out

    def forward(self, x, train=False, gen=None):
        h = torch.relu(self.bn1(self.conv1(x), train))
        h = torch.relu(self.bn2(self.conv2(h), train))
        h = self.bn3(self.conv3(h), train)
        sc = (self.bn_proj(self.proj(x), train) if self.proj is not None
              else x)
        return torch.relu(h + sc)


class ResNet50(ClassifierModel):
    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("batch_size", 128)
        config.setdefault("lr", 0.1)
        config.setdefault("weight_decay", 1e-4)
        config.setdefault("momentum", 0.9)
        config.setdefault("n_epochs", 90)
        config.setdefault("lr_schedule", {30: 0.01, 60: 1e-3, 80: 1e-4})
        super().__init__(config, device)

    def build_model(self, n_replicas: int = 1) -> None:
        s1w = int(self.config.get("stage1_width", 64))
        layers: list[Layer] = [
            Conv(s1w, 7, stride=2, pad=3, bias=False,
                 w_init=initializers.he(),
                 s2d=bool(self.config.get("stem_s2d", True))),
            BN(),
            Activation("relu"),
            Pool(3, 2, pad="SAME"),
        ]
        for stage, (blocks, ch) in enumerate(_STAGES):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layers.append(Bottleneck(s1w, stride, out_ch=ch * _EXPANSION)
                              if stage == 0 else Bottleneck(ch, stride))
        layers += [GlobalAvgPool(),
                   FC(N_CLASSES, w_init=initializers.normal(0.01))]
        self.net = Sequential(layers)
        crop = int(self.config.get("crop", CROP))
        self.input_shape = (crop, crop, 3)
        self.data = ImageNetData(
            batch_size=self.config.get("batch_size", 128),
            n_replicas=n_replicas,
            crop=crop,
            seed=self.seed,
            n_train=self.config.get("n_train"),
            n_val=self.config.get("n_val"),
        )
        self._init_params()
