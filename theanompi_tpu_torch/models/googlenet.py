"""GoogLeNet (Inception v1) on ImageNet, with auxiliary classifiers.

Port of ``theanompi_tpu/models/googlenet.py`` — ``GoogLeNet`` (Szegedy
et al. 2014) with the two auxiliary softmax heads weighted 0.3 in the
training loss; in BASELINE.json's 8-worker BSP config.

The network is a ``Layer`` of its own, not a ``Sequential``, because
the aux heads branch off inception 4a and 4d: in train mode it returns
``(main_logits, aux1_logits, aux2_logits)``, in eval mode the main
logits alone, and the aux heads are not run.  Its JAX trees are
``{stem, mid, tail, aux1, aux2}``; a fused Inception module's are
``{first, b3, b5, pproj}``.  Channel slices are on dim 1 of the port's
NCHW-indexed (``channels_last``) activations, the JAX package's last
axis.
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
    FC,
    LRN,
    Activation,
    Concat,
    Conv,
    Dropout,
    Flatten,
    GlobalAvgPool,
    Layer,
    Pool,
    Sequential,
    softmax_cross_entropy,
)


def _conv(ch, k, stride=1, pad="SAME"):
    return Sequential([
        Conv(ch, k, stride=stride, pad=pad, w_init=initializers.he()),
        Activation("relu"),
    ])


def _inception(c1, c3r, c3, c5r, c5, cp):
    """Inception module: 1x1 / 3x3(reduced) / 5x5(reduced) / pool-proj."""
    return Concat([
        _conv(c1, 1),
        Sequential([_conv(c3r, 1), _conv(c3, 3)]),
        Sequential([_conv(c5r, 1), _conv(c5, 5)]),
        Sequential([Pool(3, 1, mode="max", pad="SAME"), _conv(cp, 1)]),
    ])


class _FusedInception(Layer):
    """Inception module with the three 1x1 convs that read the same
    input (branch 1, 3x3-reduce, 5x5-reduce) fused into ONE 1x1 conv
    over c1+c3r+c5r channels, split after the shared relu — the same
    math (relu is elementwise; ``he()`` depends only on the shared
    fan-in).  The pool-proj branch reads the unpooled input through its
    own pool and cannot join; the pool holds no parameters and leaves
    no key in the JAX tree."""

    def __init__(self, c1, c3r, c3, c5r, c5, cp):
        super().__init__()
        self.sizes = (c1, c3r, c5r)
        self.first = Conv(c1 + c3r + c5r, 1, w_init=initializers.he())
        self.b3 = _conv(c3, 3)
        self.b5 = _conv(c5, 5)
        self.pool = Pool(3, 1, mode="max", pad="SAME")
        self.pproj = _conv(cp, 1)

    def init(self, gen, in_shape):
        c1, c3r, c5r = self.sizes
        sh1 = self.first.init(gen, in_shape)
        sh3 = self.b3.init(gen, sh1[:2] + (c3r,))
        sh5 = self.b5.init(gen, sh1[:2] + (c5r,))
        shp = self.pproj.init(gen, self.pool.init(gen, in_shape))
        return (in_shape[0], in_shape[1], c1 + sh3[2] + sh5[2] + shp[2])

    def forward(self, x, train=False, gen=None):
        c1, c3r, _ = self.sizes
        h = torch.relu(self.first(x))
        y3 = self.b3(h[:, c1:c1 + c3r], train=train, gen=gen)
        y5 = self.b5(h[:, c1 + c3r:], train=train, gen=gen)
        yp = self.pproj(self.pool(x), train=train, gen=gen)
        return torch.cat([h[:, :c1], y3, y5, yp], dim=1)


def _aux_head():
    """Auxiliary classifier: avgpool 5/3 -> 1x1 conv 128 -> FC1024 -> FC."""
    return Sequential([
        Pool(5, 3, mode="avg"),
        _conv(128, 1),
        Flatten(),
        FC(1024, w_init=initializers.he()),
        Activation("relu"),
        Dropout(0.7),
        FC(N_CLASSES, w_init=initializers.normal(0.01)),
    ])


class _GoogLeNetNet(Layer):
    """Trunk with two aux branch points; returns a 3-tuple in train mode."""

    def __init__(self, fused: bool = True):
        super().__init__()
        inc = _FusedInception if fused else _inception
        self.stem = Sequential([
            _conv(64, 7, stride=2),
            Pool(3, 2, pad="SAME"),
            LRN(),
            _conv(64, 1),
            _conv(192, 3),
            LRN(),
            Pool(3, 2, pad="SAME"),
            inc(64, 96, 128, 16, 32, 32),     # 3a
            inc(128, 128, 192, 32, 96, 64),   # 3b
            Pool(3, 2, pad="SAME"),
            inc(192, 96, 208, 16, 48, 64),    # 4a
        ])
        self.mid = Sequential([
            inc(160, 112, 224, 24, 64, 64),   # 4b
            inc(128, 128, 256, 24, 64, 64),   # 4c
            inc(112, 144, 288, 32, 64, 64),   # 4d
        ])
        self.tail = Sequential([
            inc(256, 160, 320, 32, 128, 128),  # 4e
            Pool(3, 2, pad="SAME"),
            inc(256, 160, 320, 32, 128, 128),  # 5a
            inc(384, 192, 384, 48, 128, 128),  # 5b
            GlobalAvgPool(),
            Dropout(0.4),
            FC(N_CLASSES, w_init=initializers.normal(0.01)),
        ])
        self.aux1 = _aux_head()
        self.aux2 = _aux_head()

    def init(self, gen, in_shape):
        sh1 = self.stem.init(gen, in_shape)
        self.aux1.init(gen, sh1)
        sh2 = self.mid.init(gen, sh1)
        self.aux2.init(gen, sh2)
        return self.tail.init(gen, sh2)

    def forward(self, x, train=False, gen=None):
        h1 = self.stem(x, train=train, gen=gen)
        h2 = self.mid(h1, train=train, gen=gen)
        main = self.tail(h2, train=train, gen=gen)
        if not train:
            return main
        return (main, self.aux1(h1, train=train, gen=gen),
                self.aux2(h2, train=train, gen=gen))


class GoogLeNet(ClassifierModel):
    """``fused_inception`` (default True) selects the fused-1x1
    Inception modules — the same math, another parameter tree, so a
    checkpoint restores only under the setting it was saved with."""

    AUX_WEIGHT = 0.3

    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("batch_size", 32)
        config.setdefault("lr", 0.01)
        config.setdefault("weight_decay", 2e-4)
        config.setdefault("n_epochs", 60)
        config.setdefault("lr_schedule", "step")
        config.setdefault("lr_step_every", 8)
        config.setdefault("lr_step_gamma", 0.96)
        super().__init__(config, device)

    def build_model(self, n_replicas: int = 1) -> None:
        self.net = _GoogLeNetNet(
            fused=bool(self.config.get("fused_inception", True)))
        crop = int(self.config.get("crop", CROP))
        self.input_shape = (crop, crop, 3)
        self.data = ImageNetData(
            batch_size=self.config.get("batch_size", 32),
            n_replicas=n_replicas,
            crop=crop,
            seed=self.seed,
            n_train=self.config.get("n_train"),
            n_val=self.config.get("n_val"),
        )
        self._init_params()

    def load(self, directory, recorder=None, **kwargs):
        """Checkpoint restore with a structure guard: the parameter tree
        depends on ``fused_inception`` (a fused module holds one merged
        1x1 weight where an unfused one holds three), so a mismatch
        surfaces as a missing or mis-shaped leaf — name the knob."""
        try:
            return super().load(directory, recorder, **kwargs)
        except (KeyError, ValueError) as e:
            raise RuntimeError(
                f"checkpoint restore failed: {e}\n"
                f"GoogLeNet's param-tree structure depends on the "
                f"'fused_inception' config knob (currently "
                f"{bool(self.config.get('fused_inception', True))}); a "
                f"checkpoint saved under the other setting must be "
                f"restored with that same setting."
            ) from e

    # aux-classifier loss (train mode returns a 3-tuple)
    def primary_logits(self, out):
        return out[0] if isinstance(out, tuple) else out

    def compute_loss(self, out, y):
        if isinstance(out, tuple):
            main, a1, a2 = out
            return (softmax_cross_entropy(main, y)
                    + self.AUX_WEIGHT * softmax_cross_entropy(a1, y)
                    + self.AUX_WEIGHT * softmax_cross_entropy(a2, y))
        return softmax_cross_entropy(out, y)
