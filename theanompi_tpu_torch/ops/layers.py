"""Layer library of the port (``theanompi_tpu/ops/layers.py``).

Each JAX layer is an init/apply pair over pytrees; here it is an
``nn.Module`` built the same way:

- ``layer.init(gen, in_shape)`` draws the parameters from the
  ``torch.Generator`` ``gen`` (on its device, fp32) and creates the
  buffers; it returns the output shape.  Shapes exclude the batch and
  are ``(H, W, C)`` as in the JAX package.
- ``layer(x, train=..., gen=...)`` -> y.  In train mode ``BN`` updates
  its running ``mean``/``var`` buffers in place (the JAX ``apply``
  returns them as new state); ``Dropout`` draws from ``gen``.
- ``layer.jax_entries(group)`` maps the JAX tree's key path of each
  leaf of ``group`` ("params" or "state") to ``(tensor, layout)``, the
  bridge the classifier models build their checkpoints and parameter
  lists from (``models/base.py``).

Activations are NCHW-indexed tensors in ``channels_last`` memory, the
JAX package's NHWC in memory.  Conv weights are OIHW (JAX: HWIO), FC
weights ``[out, in]`` (JAX: ``[in, out]``).  Casts follow the JAX code
op by op: weights are cast to ``x.dtype`` at use, BN and LRN compute in
fp32 and return ``x.dtype``, the loss is fp32.

The JAX package computes these layers outside Pallas
(``lax.conv_general_dilated``, ``lax.reduce_window``, a custom-vjp BN),
so they are plain PyTorch here: convolutions and matmuls go to cuDNN
and cuBLAS on the card.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from theanompi_tpu_torch.ops import initializers


def to_jax_layout(t: torch.Tensor, layout: str | None) -> np.ndarray:
    """A port tensor as the JAX package holds it: fp32 numpy, conv
    OIHW -> HWIO, FC ``[out, in]`` -> ``[in, out]``."""
    t = t.detach().to("cpu", torch.float32)
    if layout == "conv":
        t = t.permute(2, 3, 1, 0)
    elif layout == "fc":
        t = t.t()
    return t.contiguous().numpy()


def from_jax_layout(a, layout: str | None) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout` (a contiguous CPU tensor)."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    if layout == "conv":
        t = t.permute(3, 2, 0, 1)
    elif layout == "fc":
        t = t.t()
    return t.contiguous()


class Layer(nn.Module):
    """Base layer (see module docstring)."""

    def init(self, gen: torch.Generator, in_shape: tuple) -> tuple:
        """Create parameters and buffers; return the output shape."""
        return tuple(in_shape)

    def own_entries(self, group: str) -> dict:
        """``{name: (tensor, layout)}`` of this layer's own leaves."""
        return {}

    def jax_entries(self, group: str) -> dict:
        """``{key path: (tensor, layout)}`` of ``group`` over this layer
        and its sublayers: a named sublayer adds its name to the path,
        the entries of a list of layers (``Sequential``, ``Concat``)
        their index, as the JAX trees nest them."""
        out = {(k,): e for k, e in self.own_entries(group).items()}
        for name, child in self.named_children():
            if isinstance(child, nn.ModuleList):
                pairs = [((i,), c) for i, c in enumerate(child)]
            else:
                pairs = [((name,), child)]
            for prefix, c in pairs:
                for path, e in c.jax_entries(group).items():
                    out[prefix + path] = e
        return out


class Activation(Layer):
    """Elementwise nonlinearity: ``"relu"`` (the one the zoo names) or a
    callable."""

    def __init__(self, fn: Callable | str = "relu"):
        super().__init__()
        if isinstance(fn, str) and fn != "relu":
            raise ValueError(f"Activation {fn!r}: pass 'relu' or a callable")
        self.fn = torch.relu if fn == "relu" else fn

    def forward(self, x, train=False, gen=None):
        return self.fn(x)


def same_pads(in_hw, kernel, stride, pad) -> tuple:
    """``((top, bottom), (left, right))`` of a window op with ``pad``
    'SAME', 'VALID' or an int, as ``lax.padtype_to_pads`` resolves
    them: 'SAME' puts the odd pad at the bottom and right."""
    if isinstance(pad, int):
        return (pad, pad), (pad, pad)
    if pad == "VALID":
        return (0, 0), (0, 0)
    if pad != "SAME":
        raise ValueError(f"pad must be 'SAME', 'VALID' or an int, got "
                         f"{pad!r}")
    out = []
    for n, k, s in zip(in_hw, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return tuple(out)


def _out_hw(in_hw, kernel, stride, pad) -> tuple:
    pads = same_pads(in_hw, kernel, stride, pad)
    return tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi)
                 in zip(in_hw, kernel, stride, pads))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _chan(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over an NC... tensor."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


class Conv(Layer):
    """2-D convolution (reference: cuDNN ``dnn_conv``).

    ``pad`` is 'SAME', 'VALID', or an int of symmetric padding; an
    asymmetric 'SAME' pad is applied by ``F.pad`` before the conv.
    ``s2d=True`` is accepted with the JAX package's checks: there it is
    a TPU layout transform computing the same convolution, here the
    plain strided conv computes it."""

    def __init__(self, out_ch: int, kernel, stride=1, pad="SAME", *,
                 w_init=initializers.he(), b_init=initializers.zeros,
                 bias: bool = True, groups: int = 1, s2d: bool = False):
        super().__init__()
        self.out_ch = out_ch
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.pad = pad
        self.w_init = initializers.get(w_init)
        self.b_init = initializers.get(b_init)
        self.bias = bias
        self.groups = groups
        self.s2d = s2d
        if s2d and (not isinstance(pad, int)
                    or self.kernel[0] != self.kernel[1]
                    or self.stride[0] != self.stride[1]
                    or self.stride[0] < 2 or groups != 1):
            raise ValueError(
                "s2d needs a square kernel, symmetric stride >= 2, "
                "integer padding, and groups == 1"
            )

    def init(self, gen, in_shape):
        h, w, c = in_shape
        kh, kw = self.kernel
        wt = self.w_init(gen, (kh, kw, c // self.groups, self.out_ch))
        self.w = nn.Parameter(wt.permute(3, 2, 0, 1).contiguous())
        if self.bias:
            self.b = nn.Parameter(self.b_init(gen, (self.out_ch,)))
        return (*_out_hw((h, w), self.kernel, self.stride, self.pad),
                self.out_ch)

    def own_entries(self, group):
        if group != "params":
            return {}
        out = {"w": (self.w, "conv")}
        if self.bias:
            out["b"] = (self.b, None)
        return out

    def forward(self, x, train=False, gen=None):
        (pt, pb), (pl, pr) = same_pads(x.shape[2:], self.kernel,
                                       self.stride, self.pad)
        if pt != pb or pl != pr:
            x = F.pad(x, (pl, pr, pt, pb))
            pt = pl = 0
        y = F.conv2d(x, self.w.to(x.dtype), None, self.stride, (pt, pl), 1,
                     self.groups)
        if self.bias:
            y = y + _chan(self.b.to(y.dtype), y.dim())
        return y


def _max_pool(x, size, stride, pad):
    """Max pooling of NCHW ``x``, 'SAME' padded with -inf as
    ``lax.reduce_window`` pads."""
    (pt, pb), (pl, pr) = same_pads(x.shape[2:], size, stride, pad)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
    return F.max_pool2d(x, size, stride)


class MaxPoolTieSplit(torch.autograd.Function):
    """Max pooling with the JAX ``maxpool_tiesplit`` backward
    (``theanompi_tpu/ops/layers.py:213``): the forward is the max pool;
    the backward routes ``dy / cnt`` to every element of a window that
    attains its max, ``cnt`` being how many do, so on ties the gradient
    is split equally (PyTorch's max-pool backward, like XLA's
    ``select_and_scatter``, gives it all to one element).  A retired TPU
    experiment kept for parity: the JAX package measured it slower than
    the scatter and keeps it opt-in; here it is plain PyTorch (unfold,
    compare, fold), with ``cnt`` and the share in the input's dtype and
    the sum over windows in fp32, as the JAX backward rounds."""

    @staticmethod
    def forward(ctx, x, size, stride, pad):
        y = _max_pool(x, size, stride, pad)
        ctx.save_for_backward(x, y)
        ctx.conf = (size, stride, pad)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        size, stride, pad = ctx.conf
        n, c, h, w = x.shape
        (pt, pb), (pl, pr) = same_pads(x.shape[2:], size, stride, pad)
        xp = F.pad(x, (pl, pr, pt, pb), value=-math.inf)
        kk = size[0] * size[1]
        cols = F.unfold(xp, size, stride=stride).view(n, c, kk, -1)
        eq = cols == y.reshape(n, c, 1, -1)
        cnt = eq.to(x.dtype).sum(2, keepdim=True)
        share = dy.reshape(n, c, 1, -1).to(x.dtype) / cnt.clamp(min=1)
        contrib = (share * eq).float().view(n, c * kk, -1)
        dxp = F.fold(contrib, xp.shape[2:], size, stride=stride)
        return dxp[:, :, pt:pt + h, pl:pl + w].to(x.dtype), None, None, None


def maxpool_tiesplit(x, size, stride, pad):
    """Max pooling of NCHW ``x`` whose backward splits ties equally (see
    :class:`MaxPoolTieSplit`); ``size``/``stride`` are pairs."""
    return MaxPoolTieSplit.apply(x, tuple(size), tuple(stride), pad)


class Pool(Layer):
    """Max/avg pooling (reference: ``Pool``; JAX: ``lax.reduce_window``).

    'SAME' pads with -inf for max and 0 for avg; avg divides by the full
    window, padding included, as the JAX layer does.  ``bwd="tiesplit"``
    (or ``TM_POOL_BWD=tiesplit``, read when the layer is built) takes the
    tie-split max-pool backward, :func:`maxpool_tiesplit`."""

    def __init__(self, size=2, stride=None, mode: str = "max",
                 pad: str = "VALID", bwd: str | None = None):
        super().__init__()
        bwd = bwd if bwd is not None else os.environ.get("TM_POOL_BWD", "")
        if bwd.strip().lower() in ("", "0", "off", "default", "none",
                                   "false"):
            bwd = ""
        if bwd not in ("", "tiesplit"):
            raise ValueError(
                f"unknown Pool bwd {bwd!r} (expected 'tiesplit' or a "
                f"disable value: ''/'0'/'off'/'default'/'none')"
            )
        if mode not in ("max", "avg"):
            raise ValueError(f"Pool mode must be 'max' or 'avg', got "
                             f"{mode!r}")
        self.size = _pair(size)
        self.stride = _pair(stride if stride is not None else size)
        self.mode = mode
        self.pad = pad
        self.bwd = bwd

    def init(self, gen, in_shape):
        h, w, c = in_shape
        return (*_out_hw((h, w), self.size, self.stride, self.pad), c)

    def forward(self, x, train=False, gen=None):
        if self.mode == "max":
            if self.bwd == "tiesplit":
                return maxpool_tiesplit(x, self.size, self.stride, self.pad)
            return _max_pool(x, self.size, self.stride, self.pad)
        (pt, pb), (pl, pr) = same_pads(x.shape[2:], self.size, self.stride,
                                       self.pad)
        if pt or pb or pl or pr:
            x = F.pad(x, (pl, pr, pt, pb))
        return F.avg_pool2d(x, self.size, self.stride)


class LRN(Layer):
    """Local response normalization across channels (AlexNet-era):
    y = x / (k + a/n * sum x^2)^b over a window of ``n`` adjacent
    channels padded (n//2, n//2), in fp32."""

    def __init__(self, n: int = 5, k: float = 2.0, alpha: float = 1e-4,
                 beta: float = 0.75):
        super().__init__()
        self.n, self.k, self.alpha, self.beta = n, k, alpha, beta

    def forward(self, x, train=False, gen=None):
        half = self.n // 2
        xf = x.float()
        sq = F.pad(xf * xf, (0, 0) * (x.dim() - 2) + (half, half))
        c = x.shape[1]
        win = sq[:, 0:c]
        for i in range(1, self.n):
            win = win + sq[:, i:i + c]
        denom = torch.pow(self.k + (self.alpha / self.n) * win, -self.beta)
        return (xf * denom).to(x.dtype)


def _bn_stats(xf: torch.Tensor, axes: tuple):
    """One-pass batch statistics, as the JAX ``_bn_stats``: E[x] and
    E[x^2] together, var = max(E[x^2] - E[x]^2, 0) (biased)."""
    n = math.prod(xf.shape[a] for a in axes)
    mean = xf.sum(axes) / n
    var = torch.clamp((xf * xf).sum(axes) / n - mean * mean, min=0.0)
    return mean, var, n


class _BNTrain(torch.autograd.Function):
    """Train-mode BN with the JAX ``_bn_train`` custom-vjp backward: two
    channel reductions, sum(dy) and sum(dy*x_hat), then one elementwise
    pass for dx.  It saves ``x`` in its own dtype (bf16 on the card),
    not fp32 copies of the activation; y leaves in ``x.dtype``, so the
    incoming gradient does too.  The returned batch mean and (biased)
    variance feed the running statistics, never the loss: they are
    non-differentiable."""

    @staticmethod
    def forward(ctx, x, scale, offset, eps):
        axes = (0,) + tuple(range(2, x.dim()))
        xf = x.float()
        mean, var, _ = _bn_stats(xf, axes)
        r = torch.rsqrt(var + eps)
        y = xf - _chan(mean, x.dim())
        y.mul_(_chan(r, x.dim())).mul_(_chan(scale, x.dim()))
        y.add_(_chan(offset, x.dim()))
        ctx.save_for_backward(x, mean, r, scale)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, scale = ctx.saved_tensors
        nd = x.dim()
        axes = (0,) + tuple(range(2, nd))
        n = math.prod(x.shape[a] for a in axes)
        dyf = dy.float()
        xhat = (x.float() - _chan(mean, nd)).mul_(_chan(r, nd))
        s_dy = dyf.sum(axes)
        s_dyx = (dyf * xhat).sum(axes)
        dx = dyf - _chan(s_dy / n, nd)
        dx.sub_(xhat.mul_(_chan(s_dyx / n, nd)))
        dx.mul_(_chan(scale * r, nd))
        return dx.to(x.dtype), s_dyx, s_dy, None


class _BNTrainAxes(torch.autograd.Function):
    """``_BNTrain`` over reduction ``axes`` of a channels-last ``x``, the
    JAX ``_bn_train`` as written: statistics keep the axes not reduced,
    and broadcast against ``x`` from the right (so the reduced axes
    are the leading ones, as in every sensible use)."""

    @staticmethod
    def forward(ctx, x, scale, offset, eps, axes):
        xf = x.float()
        mean, var, _ = _bn_stats(xf, axes)
        r = torch.rsqrt(var + eps)
        y = (xf - mean) * r * scale + offset
        ctx.save_for_backward(x, mean, r, scale)
        ctx.axes = axes
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, scale = ctx.saved_tensors
        axes = ctx.axes
        n = math.prod(x.shape[a] for a in axes)
        dyf = dy.float()
        xhat = (x.float() - mean) * r
        s_dy = dyf.sum(axes)
        s_dyx = (dyf * xhat).sum(axes)
        dx = (scale * r) * (dyf - s_dy / n - xhat * (s_dyx / n))
        return dx.to(x.dtype), s_dyx, s_dy, None, None


def _channels_last(x):
    """NCHW (or [N, C]) → the JAX layout, channels last."""
    return x.permute(0, *range(2, x.dim()), 1) if x.dim() > 2 else x


def _channels_first(y):
    return y.permute(0, y.dim() - 1, *range(1, y.dim() - 1)) \
        if y.dim() > 2 else y


class BN(Layer):
    """Batch normalization with running statistics (reference: ``BN``):
    per-channel over every other axis, the running ``mean``/``var``
    buffers updated ``m*old + (1-m)*batch`` with the biased batch
    variance (``nn.BatchNorm2d`` keeps the unbiased one and the reverse
    momentum).

    ``axis`` (an int or a tuple) names the reduction axes in the JAX
    layer's channels-last layout (``[N, H, W, C]``, or ``[N, C]``), as
    the JAX ``BN(axis=…)`` reads them; the layer then normalizes in that
    layout, and its running statistics take the shape of the axes not
    reduced, as the JAX state does.  No model of the zoo sets it."""

    def __init__(self, momentum: float = 0.9, eps: float = 1e-5, axis=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.axis = (axis,) if isinstance(axis, int) else axis

    def init(self, gen, in_shape):
        c = in_shape[-1]
        dev = gen.device
        self.scale = nn.Parameter(torch.ones(c, device=dev))
        self.offset = nn.Parameter(torch.zeros(c, device=dev))
        self.register_buffer("mean", torch.zeros(c, device=dev))
        self.register_buffer("var", torch.ones(c, device=dev))
        return tuple(in_shape)

    def own_entries(self, group):
        if group == "params":
            return {"scale": (self.scale, None), "offset": (self.offset, None)}
        return {"mean": (self.mean, None), "var": (self.var, None)}

    def _forward_axes(self, x, train):
        """The ``axis`` path: channels last, the JAX arithmetic."""
        xj = _channels_last(x)
        axes = tuple(a % xj.dim() for a in self.axis)
        if train:
            y, mean, var = _BNTrainAxes.apply(xj, self.scale, self.offset,
                                              self.eps, axes)
            m = self.momentum
            with torch.no_grad():
                self.mean = m * self.mean + (1 - m) * mean
                self.var = m * self.var + (1 - m) * var
            return _channels_first(y)
        y = (xj.float() - self.mean) * torch.rsqrt(self.var + self.eps)
        y = y * self.scale + self.offset
        return _channels_first(y.to(x.dtype))

    def forward(self, x, train=False, gen=None):
        if self.axis is not None:
            return self._forward_axes(x, train)
        if train:
            y, mean, var = _BNTrain.apply(x, self.scale, self.offset,
                                          self.eps)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
            return y
        nd = x.dim()
        y = (x.float() - _chan(self.mean, nd)) * _chan(
            torch.rsqrt(self.var + self.eps), nd)
        y = y * _chan(self.scale, nd) + _chan(self.offset, nd)
        return y.to(x.dtype)


class FC(Layer):
    """Fully connected layer (reference: ``FC``): one matmul, weight
    ``[out, in]``."""

    def __init__(self, out_dim: int, *, w_init=initializers.he(),
                 b_init=initializers.zeros, bias: bool = True):
        super().__init__()
        self.out_dim = out_dim
        self.w_init = initializers.get(w_init)
        self.b_init = initializers.get(b_init)
        self.bias = bias

    def init(self, gen, in_shape):
        (d,) = in_shape
        self.w = nn.Parameter(self.w_init(gen, (d, self.out_dim)).t()
                              .contiguous())
        if self.bias:
            self.b = nn.Parameter(self.b_init(gen, (self.out_dim,)))
        return (self.out_dim,)

    def own_entries(self, group):
        if group != "params":
            return {}
        out = {"w": (self.w, "fc")}
        if self.bias:
            out["b"] = (self.b, None)
        return out

    def forward(self, x, train=False, gen=None):
        y = x @ self.w.to(x.dtype).t()
        if self.bias:
            y = y + self.b.to(y.dtype)
        return y


class Dropout(Layer):
    """Inverted dropout (reference: ``Dropout``); identity at eval.  Its
    mask is drawn from ``gen``, so it is not the JAX package's mask."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, train=False, gen=None):
        if not train or self.rate == 0.0:
            return x
        if gen is None:
            raise ValueError("Dropout needs gen when train=True")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, 0).to(x.dtype)


class Concat(Layer):
    """Parallel branches concatenated on the channel axis (Inception)."""

    def __init__(self, branches: Sequence[Layer]):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def init(self, gen, in_shape):
        shapes = [b.init(gen, in_shape) for b in self.branches]
        h, w = shapes[0][:2]
        if any(tuple(sh[:2]) != (h, w) for sh in shapes):
            raise ValueError(f"branch spatial shapes differ: {shapes}")
        return (h, w, sum(sh[2] for sh in shapes))

    def forward(self, x, train=False, gen=None):
        return torch.cat([b(x, train=train, gen=gen) for b in self.branches],
                         dim=1)


class GlobalAvgPool(Layer):
    """Spatial global average pool: NCHW -> NC."""

    def init(self, gen, in_shape):
        return (in_shape[-1],)

    def forward(self, x, train=False, gen=None):
        return x.mean(dim=(2, 3))


class Flatten(Layer):
    """Flatten in the JAX package's NHWC order, so the next FC's
    weights are the JAX ones."""

    def init(self, gen, in_shape):
        return (math.prod(in_shape),)

    def forward(self, x, train=False, gen=None):
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class Sequential(Layer):
    """Layer composition with shape inference; its JAX trees are lists
    with one entry per layer."""

    def __init__(self, layers: Sequence[Layer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def init(self, gen, in_shape):
        shape = tuple(in_shape)
        for layer in self.layers:
            shape = layer.init(gen, shape)
        return shape

    def forward(self, x, train=False, gen=None):
        for layer in self.layers:
            x = layer(x, train=train, gen=gen)
        return x


# -- losses / metrics ---------------------------------------------------------

def softmax_cross_entropy(logits, labels) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32; labels are int class ids."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def accuracy(logits, labels, k: int = 1) -> torch.Tensor:
    """Top-k accuracy, ``k`` clamped to the class count."""
    k = min(k, logits.shape[-1])
    labels = labels.long()
    if k == 1:
        return (logits.argmax(-1) == labels).float().mean()
    topk = logits.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(-1).float().mean()
