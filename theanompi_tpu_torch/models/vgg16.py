"""VGG-16 on ImageNet.

Port of ``theanompi_tpu/models/vgg16.py`` — ``VGG16`` (Simonyan &
Zisserman 2014, configuration D), in BASELINE.json's 8-worker BSP
config: thirteen 3x3 convs in five blocks, each block closed by a 2x2
max pool, then three FC layers.  ``Flatten`` keeps the JAX package's
NHWC order, so the first FC's weights are the JAX ones.
"""

from __future__ import annotations

from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.data.imagenet import (
    CROP,
    N_CLASSES,
    ImageNetData,
)
from theanompi_tpu_torch.ops import initializers
from theanompi_tpu_torch.ops.layers import (
    FC,
    Activation,
    Conv,
    Dropout,
    Flatten,
    Pool,
    Sequential,
)

# channels per conv block (config D)
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


class VGG16(ClassifierModel):
    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("batch_size", 32)   # the reference's small
        config.setdefault("lr", 0.01)          # per-GPU batches for VGG
        config.setdefault("weight_decay", 5e-4)
        config.setdefault("n_epochs", 74)
        config.setdefault("lr_schedule", "step")
        config.setdefault("lr_step_every", 30)
        super().__init__(config, device)

    def build_model(self, n_replicas: int = 1) -> None:
        layers = []
        for ch, reps in _BLOCKS:
            for _ in range(reps):
                layers += [
                    Conv(ch, 3, pad=1, w_init=initializers.he()),
                    Activation("relu"),
                ]
            layers.append(Pool(2, 2))
        layers += [
            Flatten(),
            FC(4096, w_init=initializers.normal(0.005)),
            Activation("relu"),
            Dropout(0.5),
            FC(4096, w_init=initializers.normal(0.005)),
            Activation("relu"),
            Dropout(0.5),
            FC(N_CLASSES, w_init=initializers.normal(0.01)),
        ]
        self.net = Sequential(layers)
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
