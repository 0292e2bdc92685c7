"""PyTorch/CUDA port of ``theanompi_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module layout, so each counterpart sits at
the same path.  Ported so far, for Llama at tp=1:

- serving at one card: ``models.llama.Llama`` wrapped in
  ``serving.LlamaDecoder`` or ``serving.PagedLlamaDecoder`` and driven
  by ``serving.Engine``;
- BSP training: ``BSP().init(...)`` -> ``launcher.launch`` ->
  ``workers.bsp_worker.run`` -> ``Llama.train_iter``, one process per
  device over ``torch.distributed``.

The TPU kernels on those paths are hand-written CUDA C++ in
``csrc/``: the flash-attention forward and backward (``ops.attention``)
and the paged attention (``serving.paged_attention``).

The package imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``theanompi_tpu``.  Entry points run on ``cuda`` by default;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from theanompi_tpu_torch.parallel.mesh import resolve_device
from theanompi_tpu_torch.rules import BSP, EASGD, GOSGD

__version__ = "0.2.0"

__all__ = ["BSP", "EASGD", "GOSGD", "resolve_device", "__version__"]
