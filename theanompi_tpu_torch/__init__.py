"""PyTorch/CUDA port of ``theanompi_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's module layout, so each counterpart sits at
the same path.  Ported so far:

- Llama serving at one card or tensor-parallel over a
  ``parallel.mesh.ModelGroup`` (one process a rank):
  ``models.llama.Llama`` wrapped in ``serving.LlamaDecoder`` or
  ``serving.PagedLlamaDecoder`` and driven by ``serving.Engine``, and
  the fleet over such engines: replicas
  in-process or over TCP (``serving.replica``) behind
  ``serving.Router``, resized by ``serving.Autoscaler``;
- BSP training: ``BSP().init(...)`` -> ``launcher.launch`` ->
  ``workers.bsp_worker.run`` -> the model's ``train_iter``, one process
  per device over ``torch.distributed``, for Llama and for the
  classifiers of ``models.base.ClassifierModel`` (``models.wresnet``,
  ``models.resnet50``, ``models.alex_net``, ``models.vgg16``,
  ``models.googlenet`` over ``ops.layers``; ``models.lstm``, the IMDB
  LSTM over ``ops.recurrent`` and ``models.data.imdb``), fed through
  ``data`` (pinned staging, the streaming loader);
- the asynchronous rules in one process: ``EASGD().init(...)`` /
  ``GOSGD().init(...)`` -> ``launcher.launch`` ->
  ``workers.easgd_worker.run`` / ``workers.gosgd_worker.run`` ->
  ``workers.replica_engine.ReplicaEngine`` (W replicas stacked on one
  device, ``devices=["cpu"] * W`` or ``[0] * W``), exchanging through
  the ``parallel.exchange`` merges (``elastic_*``, ``gossip_*``).

The TPU kernels on those paths are hand-written CUDA C++ in
``csrc/``: the flash-attention forward and backward (``ops.attention``)
and the paged attention (``serving.paged_attention``); so is the
serving decoders' RMS norm (``ops.norm``), whose rows do not depend on
the call's row count.  The classifier
and async paths run no TPU kernel: their convolutions and matmuls are
cuDNN's and cuBLAS's, BN, pooling, LRN and the LSTM cell plain
PyTorch.

The package imports ``torch`` and ``numpy`` only, never ``jax`` and
nothing of ``theanompi_tpu``.  Entry points run on ``cuda`` by default;
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from theanompi_tpu_torch.parallel.mesh import resolve_device
from theanompi_tpu_torch.rules import BSP, EASGD, GOSGD

__version__ = "0.2.0"

__all__ = ["BSP", "EASGD", "GOSGD", "resolve_device", "__version__"]
