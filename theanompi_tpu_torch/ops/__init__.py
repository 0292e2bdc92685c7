"""Ops of the port: attention (kernel K1 and its plain version), the
layer library and initializers of the CNN zoo, and the optimizers."""

from theanompi_tpu_torch.ops import initializers
from theanompi_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention,
    flash_attention_fwd,
    mha_reference,
)
from theanompi_tpu_torch.ops.layers import (
    BN,
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
    accuracy,
    softmax_cross_entropy,
)
from theanompi_tpu_torch.ops.optimizers import (
    Optimizer,
    adam,
    momentum,
    nesterov,
    sgd,
)

__all__ = ["NEG_INF", "flash_attention", "flash_attention_fwd",
           "mha_reference", "initializers", "Layer", "Sequential", "Conv",
           "Concat", "Pool", "LRN", "BN", "FC", "Dropout", "Flatten",
           "GlobalAvgPool", "Activation", "softmax_cross_entropy",
           "accuracy", "sgd", "momentum", "nesterov", "adam", "Optimizer"]
