"""PyTorch/CUDA port of ``theanompi_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module layout, so each counterpart sits at
the same path.  Ported so far:

- Llama serving at one card (tp=1): ``models.llama.Llama`` wrapped in
  ``serving.LlamaDecoder`` or ``serving.PagedLlamaDecoder`` and driven
  by ``serving.Engine``;
- BSP training: ``BSP().init(...)`` -> ``launcher.launch`` ->
  ``workers.bsp_worker.run`` -> the model's ``train_iter``, one process
  per device over ``torch.distributed``, for Llama and for the image
  classifiers of ``models.base.ClassifierModel`` (``models.wresnet``,
  ``models.resnet50``, ``models.alex_net``) over ``ops.layers``.

The TPU kernels on those paths are hand-written CUDA C++ in
``csrc/``: the flash-attention forward and backward (``ops.attention``)
and the paged attention (``serving.paged_attention``).  The classifier
path runs no TPU kernel: its convolutions and matmuls are cuDNN's and
cuBLAS's, its BN, pooling and LRN plain PyTorch.

The package imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``theanompi_tpu``.  Entry points run on ``cuda`` by default;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from theanompi_tpu_torch.parallel.mesh import resolve_device
from theanompi_tpu_torch.rules import BSP, EASGD, GOSGD

__version__ = "0.2.0"

__all__ = ["BSP", "EASGD", "GOSGD", "resolve_device", "__version__"]
