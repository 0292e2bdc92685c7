"""Optimizer updates with the JAX package's exact forms.

Port of ``theanompi_tpu/ops/optimizers.py``.  An ``Optimizer`` pairs
``init(params) -> state`` with ``update(params, grads, state, lr)``;
here ``update`` writes the new parameters and state IN PLACE (the
tensors are the trained model's, and a fresh copy of an 8B-scale tree
per step would double its memory) and returns the state.  ``params``
and ``grads`` are lists of tensors in one order; the state keeps the
JAX layout — ``()`` for SGD, the velocity list for (Nesterov)
momentum, ``{"m", "v", "t"}`` for Adam with ``t`` an int32 scalar —
so a checkpoint crosses between the packages.

The forms are the JAX ones, not ``torch.optim``'s, whose rounding and
weight decay differ: weight decay is added to the gradient for
SGD/momentum, and to the STEP for Adam (``lr*wd*p``); Adam's bias terms
are computed in float32 from the float32 step count, as
``t.astype(float32)`` does.  Python-float hyperparameters meet float32
tensors, so every product rounds as the JAX weak-typed scalars do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[list], Any]
    update: Callable[..., Any]
    # update(params, grads, state, lr) -> state (params updated in place)


def _zeros_like(params):
    return [torch.zeros_like(p) for p in params]


def sgd(weight_decay: float = 0.0) -> Optimizer:
    """Vanilla SGD: p -= lr * (g + wd*p)."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(params, grads, state, lr):
        for p, g in zip(params, grads):
            if weight_decay:
                g = g + weight_decay * p
            p.copy_(p - lr * g)
        return state

    return Optimizer(init, update)


def momentum(mu: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Classical momentum: v = mu*v - lr*g; p += v."""

    def init(params):
        return _zeros_like(params)

    @torch.no_grad()
    def update(params, grads, velocity, lr):
        for p, g, v in zip(params, grads, velocity):
            if weight_decay:
                g = g + weight_decay * p
            v.copy_(mu * v - lr * g)
            p.copy_(p + v)
        return velocity

    return Optimizer(init, update)


def nesterov(mu: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Nesterov momentum: v = mu*v - lr*g; p += mu*v - lr*g."""

    def init(params):
        return _zeros_like(params)

    @torch.no_grad()
    def update(params, grads, velocity, lr):
        for p, g, v in zip(params, grads, velocity):
            if weight_decay:
                g = g + weight_decay * p
            v.copy_(mu * v - lr * g)
            p.copy_(p + mu * v - lr * g)
        return velocity

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam: m, v moments; step = lr*(m/bias1)/(sqrt(v/bias2)+eps)
    (+ lr*wd*p)."""

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(params, grads, state, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bias1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32),
                                    tf))
        bias2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32),
                                    tf))
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            step = lr * (m / bias1) / (torch.sqrt(v / bias2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p
            p.copy_(p - step)
        state["t"] = t
        return state

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "nesterov": nesterov,
              "adam": adam}


def get(name: str, **kwargs) -> Optimizer:
    try:
        return OPTIMIZERS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}"
        ) from None
