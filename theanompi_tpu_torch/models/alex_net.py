"""AlexNet on ImageNet — the reference's primary benchmark model.

Port of ``theanompi_tpu/models/alex_net.py``: batch 128, SGD + momentum
0.9, weight decay 5e-4, LRN after conv1/conv2 (one-tower variant of
Krizhevsky et al. 2012).  ``Flatten`` keeps the JAX package's NHWC
order, so the first FC's weights are the JAX ones.
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
    LRN,
    Activation,
    Conv,
    Dropout,
    Flatten,
    Pool,
    Sequential,
)


class AlexNet(ClassifierModel):
    def __init__(self, config: dict | None = None, device=None):
        config = dict(config or {})
        config.setdefault("batch_size", 128)
        config.setdefault("lr", 0.01)
        config.setdefault("weight_decay", 5e-4)
        config.setdefault("momentum", 0.9)
        config.setdefault("n_epochs", 70)
        # reference-style step schedule: /10 at epochs 30 and 60
        config.setdefault("lr_schedule", {30: 1e-3, 60: 1e-4})
        super().__init__(config, device)

    def build_model(self, n_replicas: int = 1) -> None:
        def relu():
            return Activation("relu")

        gauss = initializers.normal(0.01)
        self.net = Sequential([
            Conv(96, 11, stride=4, pad=2, w_init=gauss), relu(),
            LRN(n=5, alpha=1e-4, beta=0.75),
            Pool(3, 2),
            Conv(256, 5, pad=2, w_init=gauss,
                 b_init=initializers.constant(0.1)), relu(),
            LRN(n=5, alpha=1e-4, beta=0.75),
            Pool(3, 2),
            Conv(384, 3, pad=1, w_init=gauss), relu(),
            Conv(384, 3, pad=1, w_init=gauss,
                 b_init=initializers.constant(0.1)), relu(),
            Conv(256, 3, pad=1, w_init=gauss,
                 b_init=initializers.constant(0.1)), relu(),
            Pool(3, 2),
            Flatten(),
            FC(4096, w_init=initializers.normal(0.005),
               b_init=initializers.constant(0.1)), relu(),
            Dropout(0.5),
            FC(4096, w_init=initializers.normal(0.005),
               b_init=initializers.constant(0.1)), relu(),
            Dropout(0.5),
            FC(N_CLASSES, w_init=gauss),
        ])
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
