"""Adapter: any ``torch.nn.Module`` → the Theano-MPI model contract.

Port of ``theanompi_tpu/models/flax_zoo/adapter.py``, whose
``FlaxLayer`` maps linen's ``init``/``apply`` onto the ``ops.Layer``
protocol.  Here the frontend is ``torch.nn``:

- ``TorchLayer`` holds a module's parameters and buffers as tensors of
  its own (drawn from the explicit generator, on the model's device)
  and applies the module over them with ``torch.func.functional_call``,
  never over the module's own ``Parameter``s (which live on the
  ``meta`` device).  So the contract's tensors are the ones the forward
  reads and BN's running statistics update in place, and the async
  rules' replica engine, which points them at slots of its ``[W, ...]``
  stacks, steps each replica's own copy.  They appear under the JAX key
  paths of the module's submodule names (the zoo names its submodules
  after linen's auto-names, ``Conv_0``, ``BatchNorm_1``, ``Dense_0``,
  ``_ResBlock_3``, so the paths are the flax tree's) with their
  ``jax_view`` layouts: conv kernels HWIO, ``Linear`` kernels
  ``[in, out]``; buffers under ``("batch_stats", ...)``.
- ``TorchClassifier`` is the model class: a ``module_factory`` and a
  ``data_factory`` (CIFAR-10 by default) give a contract-conforming
  ``ClassifierModel``; ``params_from_flax`` adopts the JAX package's
  flax variables and ``params_to_flax`` returns them.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn as nn
from torch.func import functional_call

from theanompi_tpu_torch.models.base import ClassifierModel
from theanompi_tpu_torch.models.data.cifar10 import SHAPE, Cifar10Data
from theanompi_tpu_torch.ops.layers import Layer

#: torch leaf names under their linen names (``nn.BatchNorm*`` in a
#: module the zoo did not write)
_RENAME = {"running_mean": "mean", "running_var": "var"}
#: the linen state collection the buffers ride in
STATE = "batch_stats"


def lecun_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """linen's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``, over a JAX-layout ``shape`` (conv HWIO, dense
    ``[in, out]``): fan_in is every dim but the last."""
    std = math.sqrt(1.0 / math.prod(shape[:-1])) / .87962566103423978
    t = torch.empty(tuple(shape), device=gen.device)
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def _leaf(owner: nn.Module, name: str) -> tuple[str, str | None]:
    """(linen name, layout) of ``owner``'s leaf ``name``."""
    if name == "weight" and isinstance(owner, nn.Conv2d):
        return "kernel", "conv"
    if name == "weight" and isinstance(owner, nn.Linear):
        return "kernel", "fc"
    if name == "weight" and isinstance(owner, nn.modules.batchnorm._NormBase):
        return "scale", None
    return _RENAME.get(name, name), None


def _draw(gen, owner: nn.Module, name: str, value: torch.Tensor):
    """A parameter drawn from ``gen`` as linen draws its default: conv
    and dense kernels ``lecun_normal``, biases zeros; any other leaf
    keeps the module's own initial value."""
    leaf, layout = _leaf(owner, name)
    if leaf == "kernel":
        if layout == "conv":
            return lecun_normal(gen, tuple(value.shape[2:])
                                + (value.shape[1], value.shape[0])
                                ).permute(3, 2, 0, 1).contiguous()
        return lecun_normal(gen, tuple(value.shape[::-1])).t().contiguous()
    if leaf == "bias":
        return torch.zeros(value.shape, device=gen.device)
    return value.detach().to(gen.device, torch.float32).clone()


class TorchLayer(Layer):
    """Wrap an ``nn.Module`` mapping the classifier's input (NCHW-indexed,
    ``channels_last``) to logits as an ``ops.layers.Layer``: the module
    is called as ``module(x, train=train)``; in train mode dropout draws
    from ``gen`` (the global RNG forked and seeded from it), never from
    the global stream."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        #: the module's parameters and buffers by their torch names
        self._tensors: dict[str, torch.Tensor] = {}
        self._entries: dict[str, dict] = {"params": {}, "state": {}}

    def init(self, gen: torch.Generator, in_shape: tuple) -> tuple:
        self._tensors = {}
        self._entries = {"params": {}, "state": {}}
        mod = self.module
        for group, named in (("params", mod.named_parameters()),
                             ("state", mod.named_buffers())):
            for name, value in named:
                path = name.split(".")
                owner = mod.get_submodule(".".join(path[:-1]))
                if group == "params":
                    t = _draw(gen, owner, path[-1], value).requires_grad_()
                else:
                    t = value.detach().to(gen.device).clone()
                self._tensors[name] = t
                leaf, layout = _leaf(owner, path[-1])
                if t.is_floating_point():
                    key = tuple(path[:-1]) + (leaf,)
                    if group == "state":
                        key = (STATE,) + key
                    self._entries[group][key] = (t, layout)
        # the module's own leaves hold no memory and cannot be read
        mod.to("meta")
        h, w, c = in_shape
        probe = {k: torch.empty_like(t, device="meta")
                 for k, t in self._tensors.items()}
        out = functional_call(mod, probe,
                              (torch.empty((1, c, h, w), device="meta"),),
                              {"train": False})
        return tuple(out.shape[1:])

    def own_entries(self, group: str) -> dict:
        """``{JAX key path: (tensor, layout)}`` of ``group``."""
        return dict(self._entries[group])

    def jax_entries(self, group: str) -> dict:
        return self.own_entries(group)

    def forward(self, x, train=False, gen=None):
        kw = {"train": train}
        if not (train and gen is not None):
            return functional_call(self.module, self._tensors, (x,), kw)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        cards = [gen.device] if gen.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cards):
            torch.manual_seed(seed)
            return functional_call(self.module, self._tensors, (x,), kw)


class TorchClassifier(ClassifierModel):
    """Contract-conforming classifier around an ``nn.Module``.

    Subclasses (or callers) provide ``module_factory(config) ->
    nn.Module`` and optionally ``data_factory(config, n_replicas)``
    (default: CIFAR-10, the Lasagne zoo's demo dataset scale), as the
    JAX ``FlaxClassifier``.
    """

    def __init__(
        self,
        config: dict | None = None,
        device=None,
        *,
        module_factory: Callable[[dict], nn.Module] | None = None,
        data_factory: Callable[[dict, int], Any] | None = None,
        input_shape: tuple = SHAPE,
    ):
        super().__init__(config, device)
        if module_factory is not None:
            self.module_factory = module_factory
        if data_factory is not None:
            self.data_factory = data_factory
        self._input_shape = tuple(input_shape)

    # overridable hooks ---------------------------------------------------

    def module_factory(self, config: dict) -> nn.Module:
        raise NotImplementedError(
            "pass module_factory= or subclass TorchClassifier")

    def data_factory(self, config: dict, n_replicas: int):
        return Cifar10Data(
            batch_size=config.get("batch_size", 128),
            n_replicas=n_replicas,
            seed=self.seed,
            n_train=config.get("n_train"),
            n_val=config.get("n_val"),
        )

    # contract ------------------------------------------------------------

    def build_model(self, n_replicas: int = 1) -> None:
        self.net = TorchLayer(self.module_factory(self.config))
        self.input_shape = self._input_shape
        self.data = self.data_factory(self.config, n_replicas)
        self._init_params()

    # the JAX package's flax variables -----------------------------------

    def params_from_flax(self, variables: dict) -> None:
        """Adopt a flax variables dict of numpy arrays (``{"params":
        ..., "batch_stats": ...}``, e.g. ``jax.device_get`` of the JAX
        ``FlaxClassifier``'s ``params`` and ``net_state``)."""
        self.restore_trees({
            "params": variables["params"],
            "net_state": {k: v for k, v in variables.items()
                          if k != "params"}})

    def params_to_flax(self) -> dict:
        """Inverse of :meth:`params_from_flax`: the flax variables, numpy
        in the JAX layout (the checkpoint's ``params`` and
        ``net_state`` trees)."""
        return {"params": self._jax_tree(self._params_at),
                **self._jax_tree(self._state_at)}
