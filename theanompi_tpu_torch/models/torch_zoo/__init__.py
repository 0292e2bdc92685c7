"""The ``torch.nn`` model zoo: third-party-frontend integration.

Counterpart of the JAX package's ``models/flax_zoo/`` (which adapts
``flax.linen``, as the reference's ``lasagne_model_zoo`` adapted
Lasagne): in the port the frontend is PyTorch itself, so
``TorchClassifier`` adapts any ``torch.nn.Module`` producing logits to
the contract, and it trains under BSP/EASGD/GoSGD like the in-tree zoo.
``TorchCNN`` and ``TorchResNet18`` are ``flax_zoo``'s ``FlaxCNN`` and
``FlaxResNet18``, layer for layer, their parameters under linen's key
paths.
"""

from theanompi_tpu_torch.models.torch_zoo.adapter import (
    TorchClassifier,
    TorchLayer,
)
from theanompi_tpu_torch.models.torch_zoo.cnn import TorchCNN, TorchResNet18

__all__ = ["TorchClassifier", "TorchLayer", "TorchCNN", "TorchResNet18"]
