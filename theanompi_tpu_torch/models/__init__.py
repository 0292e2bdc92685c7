"""Models of the port: Llama (serving and BSP training), the image
classifiers WResNet, ResNet-50, AlexNet, VGG16 and GoogLeNet, and the
IMDB LSTM (training under BSP, EASGD and GoSGD)."""

from theanompi_tpu_torch.models.alex_net import AlexNet
from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.googlenet import GoogLeNet
from theanompi_tpu_torch.models.llama import (
    LLAMA3_8B,
    Llama,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from theanompi_tpu_torch.models.lstm import LSTM
from theanompi_tpu_torch.models.resnet50 import ResNet50
from theanompi_tpu_torch.models.vgg16 import VGG16
from theanompi_tpu_torch.models.wresnet import WResNet

__all__ = ["AlexNet", "ClassifierModel", "GoogLeNet", "LLAMA3_8B", "LSTM",
           "Llama", "ResNet50", "VGG16", "WResNet", "opt_state_from_jax",
           "opt_state_to_jax", "params_from_jax", "params_to_jax"]
