"""PyTorch/CUDA port of ``theanompi_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module layout, so each counterpart sits at
the same path.  This slice covers Llama serving at one card and tp=1:
``models.llama.Llama`` wrapped in ``serving.LlamaDecoder`` or
``serving.PagedLlamaDecoder`` and driven by ``serving.Engine``.  The
two TPU kernels on that path are hand-written CUDA C++ in ``csrc/``:
the flash-attention forward (``ops.attention``) and the paged
attention (``serving.paged_attention``).

The package imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``theanompi_tpu``.  Entry points run on ``cuda`` by default;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from theanompi_tpu_torch.parallel.mesh import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
