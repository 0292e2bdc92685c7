"""Weight initialization schemes.

Port of ``theanompi_tpu/ops/initializers.py``: each scheme is a function
``(gen, shape, dtype) -> tensor`` drawing from the ``torch.Generator``
``gen`` on ``gen``'s device.  Shapes are in the JAX layout (FC
``[in, out]``, conv ``[H, W, I, O]``), so ``_fans`` reads them as the
JAX package does; a layer moves the drawn tensor into its own layout.
The distributions are the JAX ones, the numbers are not: torch cannot
reproduce ``jax.random`` (parity tests carry the JAX parameters across
through the bridge in ``models/base.py``).
"""

from __future__ import annotations

import math

import torch


def _fans(shape) -> tuple[int, int]:
    """(fan_in, fan_out) for FC [in, out] and conv [H, W, I, O] shapes."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def constant(value: float):
    def init(gen, shape, dtype=torch.float32):
        return torch.full(tuple(shape), value, dtype=dtype, device=gen.device)

    return init


zeros = constant(0.0)
ones = constant(1.0)


def _randn(gen, shape, dtype):
    return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                       device=gen.device)


def _uniform(gen, shape, dtype, lo, hi):
    return torch.empty(tuple(shape), dtype=dtype,
                       device=gen.device).uniform_(lo, hi, generator=gen)


def normal(std: float = 0.01, mean: float = 0.0):
    def init(gen, shape, dtype=torch.float32):
        return mean + std * _randn(gen, shape, dtype)

    return init


def uniform(scale: float = 0.05):
    def init(gen, shape, dtype=torch.float32):
        return _uniform(gen, shape, dtype, -scale, scale)

    return init


def xavier(gain: float = 1.0):
    """Glorot uniform: U(±gain * sqrt(6 / (fan_in + fan_out)))."""

    def init(gen, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, dtype, -limit, limit)

    return init


def he(gain: float = 2.0):
    """He/Kaiming normal: N(0, sqrt(gain / fan_in)) — for ReLU nets."""

    def init(gen, shape, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        return _randn(gen, shape, dtype) * math.sqrt(gain / fan_in)

    return init


def get(spec):
    """Resolve an initializer spec: callable | name | (name, kwargs)."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        return {
            "zeros": zeros,
            "ones": ones,
            "normal": normal(),
            "uniform": uniform(),
            "xavier": xavier(),
            "he": he(),
        }[spec]
    name, kwargs = spec
    return {
        "constant": constant,
        "normal": normal,
        "uniform": uniform,
        "xavier": xavier,
        "he": he,
    }[name](**kwargs)
