"""Data modules of the port (numpy only, copied from the JAX
package): the same seed gives both packages the same batches."""

from theanompi_tpu_torch.models.data.cifar10 import Cifar10Data
from theanompi_tpu_torch.models.data.imagenet import ImageNetData
from theanompi_tpu_torch.models.data.imdb import ImdbData
from theanompi_tpu_torch.models.data.lm_synthetic import MarkovLMData
from theanompi_tpu_torch.models.data.synthetic import SyntheticClassData

__all__ = ["Cifar10Data", "ImageNetData", "ImdbData", "MarkovLMData",
           "SyntheticClassData"]
