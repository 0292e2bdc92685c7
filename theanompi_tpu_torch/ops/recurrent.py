"""Recurrent layers: Embedding + LSTM (port of
``theanompi_tpu/ops/recurrent.py``, the reference's Lasagne LSTM for
IMDB sentiment).

The JAX package runs the recurrence as a ``lax.scan`` of plain matmuls
outside any Pallas kernel, so here it is a Python loop over time of
``torch.matmul`` and elementwise ops (no kernel of this package):

- the input projection of every step is one ``[B*T, E] x [E, 4H]``
  product before the loop; each step adds ``h @ wh``;
- gate order (i, f, g, o), forget bias initialized to 1;
- a {0,1} pad mask holds h and c on padded steps, then a masked mean
  pool whose denominator is clamped at 1 (``pool="last"``: the state
  after the last step; ``"seq"``: every step's h).

Dtypes follow the JAX cell: the weights are cast to the input's dtype
and h and c are carried in it, so under bf16 compute every gate and
state rounds to bf16 after each op, as the scan does; carrying c in
fp32 would be a different result.  Weights keep the JAX layout
(``wx`` ``[E, 4H]``, ``wh`` ``[H, 4H]``), so ``jax_entries`` maps them
with no transpose.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from theanompi_tpu_torch.ops import initializers
from theanompi_tpu_torch.ops.layers import Layer


class Embedding(Layer):
    """Token id -> vector table lookup; ``out_dtype`` casts the table
    (int ids carry no dtype to follow)."""

    def __init__(self, vocab: int, dim: int, *,
                 w_init=initializers.normal(0.01), out_dtype=None):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        self.w_init = initializers.get(w_init)
        self.out_dtype = out_dtype

    def init(self, gen, in_shape):
        self.w = nn.Parameter(self.w_init(gen, (self.vocab, self.dim)))
        return (*in_shape, self.dim)

    def own_entries(self, group):
        return {"w": (self.w, None)} if group == "params" else {}

    def forward(self, x, train=False, gen=None):
        w = self.w if self.out_dtype is None else self.w.to(self.out_dtype)
        return w[x.long()]


class LSTM(Layer):
    """Single-layer LSTM over ``[B, T, E]`` -> pooled ``[B, H]`` (or
    ``[B, T, H]`` with ``pool="seq"``); see the module docstring."""

    def __init__(self, hidden: int, *, pool: str = "mean",
                 w_init=initializers.xavier()):
        super().__init__()
        if pool not in ("mean", "last", "seq"):
            raise ValueError(f"pool must be 'mean', 'last' or 'seq', got "
                             f"{pool!r}")
        self.hidden = hidden
        self.pool = pool
        self.w_init = initializers.get(w_init)

    def init(self, gen, in_shape):
        t, e = in_shape
        h = self.hidden
        self.wx = nn.Parameter(self.w_init(gen, (e, 4 * h)))
        self.wh = nn.Parameter(self.w_init(gen, (h, 4 * h)))
        b = torch.zeros(4 * h, device=gen.device)
        b[h:2 * h] = 1.0                      # forget bias
        self.b = nn.Parameter(b)
        return (t, h) if self.pool == "seq" else (h,)

    def own_entries(self, group):
        if group != "params":
            return {}
        return {"wx": (self.wx, None), "wh": (self.wh, None),
                "b": (self.b, None)}

    def forward(self, x, train=False, gen=None, mask=None):
        b, t, e = x.shape
        hd = self.hidden
        dtype = x.dtype
        wx, wh = self.wx.to(dtype), self.wh.to(dtype)
        bias = self.b.to(dtype)
        mask = (torch.ones((b, t), dtype=dtype, device=x.device)
                if mask is None else mask.to(dtype))
        xz = (x.reshape(b * t, e) @ wx).reshape(b, t, 4 * hd) + bias
        h = c = torch.zeros((b, hd), dtype=dtype, device=x.device)
        hs = []
        for s in range(t):
            z = xz[:, s] + h @ wh
            i, f, g, o = z.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[:, s, None]
            h = m * h_new + (1 - m) * h       # hold state on padding
            c = m * c_new + (1 - m) * c
            hs.append(h)
        if self.pool == "last":
            return h
        hs = torch.stack(hs, dim=1)           # [B, T, H]
        if self.pool == "seq":
            return hs
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        return (hs * mask[:, :, None]).sum(dim=1) / denom
