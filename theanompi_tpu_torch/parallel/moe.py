"""Mixture-of-Experts FFN with expert parallelism over the expert axis
of a :class:`~theanompi_tpu_torch.parallel.mesh.Layout`.

Port of ``theanompi_tpu/parallel/moe.py`` (the GShard/Switch capacity
formulation, every shape static):

- **Routing**: a softmax over ``E`` experts in fp32 and the top-k
  picks, their gates renormalised to sum to one (the Mixtral
  convention).  ``lax.top_k`` gives the lower index first on ties;
  ``torch.topk`` promises no order, so :func:`router_topk` takes the
  first k of a stable descending sort.
- **Dispatch** is capacity-based and slot-major: every token's first
  pick is ranked before any token's second, positions come from one
  cumulative sum over a ``[k·N, E]`` one-hot, picks past an expert's
  capacity ``C`` are dropped (combine weight zero).  One int scatter
  builds the inverse plan and one row gather the ``[E, C, D]`` buffer.
- **Expert parallelism**: each rank of the expert group of size ``ep``
  owns ``E/ep`` experts.  The JAX ``lax.all_to_all(split_axis=0,
  concat_axis=1, tiled=True)`` maps ``[E, C, D]`` to ``[E/ep, ep·C,
  D]``, the source rank major along the capacity axis; here it is an
  ``all_to_all_single`` (which splits dim 0 and stacks what it receives
  by source) between two permutes, an autograd function whose backward
  is the reverse all-to-all (and the same for the way home).  Expert
  weights compose with tp the Megatron way: gate and up sharded on the
  FFN dim, down on its rows, the closing sum through
  ``tp.reduce_from_group``; the buffer enters the products through
  ``tp.copy_to_group`` (JAX's implicit ``pvary`` of the model-invariant
  buffer, whose transpose sums the model ranks' partial cotangents).
  The router reads the model-invariant input directly.
- **Aux losses**: the Switch load balance ``E · Σ f·p`` and the router
  z-loss ``mean(logsumexp(logits)²)``, from moments meaned over the
  token-sharding ranks (``batch_group``: expert × data × seq, n ranks).
  That mean's backward is the identity.  In JAX the ``pmean``
  transposes to cotangent / n, and the invariant aux meets each rank's
  varying loss through an implicit ``pvary``, whose transpose sums the
  cotangents of the n / sp expert × data ranks: a net 1 / sp, which
  JAX's autodiff psum over seq undoes; the port's exchange means over
  seq instead of summing, so its net factor is 1.

Capacity per expert is ``ceil(cf·k·N/E)`` rounded up to a multiple of
8 (the JAX TPU sublane rounding, kept so the shapes and drops are the
JAX package's), with ``N`` the LOCAL token count; ``cf >= E/k`` drops
nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from theanompi_tpu_torch.parallel import tp as tp_lib


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Static per-expert capacity for ``n_tokens`` local tokens: a
    multiple of 8 in ``[8, ceil8(n_tokens)]``."""
    c = int(-(-capacity_factor * top_k * n_tokens // n_experts))
    c = -(-c // 8) * 8
    return max(8, min(c, -(-n_tokens // 8) * 8))


def router_topk(x2, w_router, top_k: int, renormalize: bool = True):
    """fp32 router: ``(gates [N, k], expert ids [N, k], probs [N, E],
    logits [N, E])`` of ``x2`` ``[N, D]``; ties go to the lower expert
    id, as ``lax.top_k``'s."""
    logits = x2.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
    eidx = order[:, :top_k]
    gates = torch.gather(probs, 1, eidx)
    if renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, eidx, probs, logits


class _GroupMean(torch.autograd.Function):
    """The mean over a group, its cotangent passed through unchanged
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, v, group):
        out = v.detach().clone().contiguous()
        dist.all_reduce(out, group=group.device_group)
        return out / group.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_mean(v: torch.Tensor, group) -> torch.Tensor:
    """``v`` meaned over ``group`` (the token-sharding ranks); itself
    without a group of more than one rank."""
    if group is None or group.size == 1:
        return v
    return _GroupMean.apply(v, group)


def aux_moments(eidx, probs, n_experts: int, batch_group=None):
    """The load balance's linear moments: ``f`` ``[E]``, the fraction of
    (token, slot) picks routed to each expert (no gradient, as in
    Switch), and ``p`` ``[E]``, the mean router probability; global means
    over ``batch_group``."""
    n, k = eidx.shape
    counts = F.one_hot(eidx, n_experts).float().sum(dim=(0, 1))
    f = counts / (n * k)
    p = probs.mean(dim=0)
    return group_mean(f, batch_group), group_mean(p, batch_group)


def load_balance_loss(eidx, probs, n_experts: int, batch_group=None):
    """``E · Σ_e f_e · p_e`` over all k picks; 1.0 when both are
    uniform."""
    f, p = aux_moments(eidx, probs, n_experts, batch_group)
    return n_experts * (f * p).sum()


def router_z_loss(logits, batch_group=None):
    """``mean(logsumexp(logits)²)``, meaned over ``batch_group``."""
    return group_mean(torch.logsumexp(logits, dim=-1).square().mean(),
                      batch_group)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` ``[ep, ...]`` (chunk j to rank j),
    received stacked by source rank."""
    x = x.contiguous()          # empty_like keeps a view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.device_group)
    _a2a.calls += 1
    return out


_a2a.calls = 0


def _dispatch(buf, group):
    """``[E, C, D]`` -> ``[E/ep, ep·C, D]`` (JAX ``split_axis=0,
    concat_axis=1, tiled=True``)."""
    ep = group.size
    e, c, d = buf.shape
    got = _a2a(buf.reshape(ep, e // ep, c, d), group)   # [src, E/ep, C, D]
    return got.transpose(0, 1).reshape(e // ep, ep * c, d)


def _combine(out, group):
    """``[E/ep, ep·C, D]`` -> ``[E, C, D]`` (JAX ``split_axis=1,
    concat_axis=0, tiled=True``): the inverse of :func:`_dispatch`."""
    ep = group.size
    el, epc, d = out.shape
    c = epc // ep
    send = out.reshape(el, ep, c, d).transpose(0, 1)    # [dst, E/ep, C, D]
    return _a2a(send, group).reshape(el * ep, c, d)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        return _dispatch(buf, group)

    @staticmethod
    def backward(ctx, g):
        return _combine(g, ctx.group), None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, group):
        ctx.group = group
        return _combine(out, group)

    @staticmethod
    def backward(ctx, g):
        return _dispatch(g, ctx.group), None


def moe_ffn(x, w_router, we_gate, we_up, we_down, *, n_experts: int,
            top_k: int = 2, capacity_factor: float = 1.25,
            expert_group=None, model_group=None, batch_group=None,
            renormalize: bool = True):
    """The MoE SwiGLU FFN on this rank's tokens.

    - ``x``: ``[B, T, D]`` (the expert products run in ``x.dtype``, the
      routing and the combine in fp32).
    - ``w_router``: ``[D, E]``; ``we_gate``/``we_up``: ``[E/ep, D,
      F/tp]``; ``we_down``: ``[E/ep, F/tp, D]``.
    - ``expert_group``, ``model_group``, ``batch_group``: this rank's
      expert, model and token-sharding groups (None: one rank).

    Returns ``(y [B, T, D], aux)``, ``aux`` = ``{"lb", "z", "f", "p"}``
    as in JAX (``f``/``p`` the linear moments a pipelined caller means
    over its microbatches before forming ``E·Σ f·p``).
    """
    b, t, d = x.shape
    n = b * t
    e = n_experts
    x2 = x.reshape(n, d)
    ep = expert_group.size if expert_group is not None else 1
    if e % ep:
        raise ValueError(f"n_experts {e} must divide by ep {ep}")
    if we_gate.shape[0] != e // ep:
        raise ValueError(f"expert leaf holds {we_gate.shape[0]} experts, "
                         f"expected {e}/{ep} = {e // ep}")
    c = moe_capacity(n, e, top_k, capacity_factor)

    gates, eidx, probs, logits = router_topk(x2, w_router, top_k,
                                             renormalize)
    f, p = aux_moments(eidx, probs, e, batch_group)
    aux = {"f": f, "p": p, "lb": e * (f * p).sum(),
           "z": router_z_loss(logits, batch_group)}

    # the slot-major plan: slot j's block holds every token's j-th pick
    flat_e = eidx.t().reshape(-1)                               # [k*N]
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)
              ).to(torch.int32)                                 # [k*N, E]
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                       flat_e[:, None])[:, 0]                   # int64
    keep = pos < c
    dest = torch.where(keep, flat_e * c + pos,
                       torch.full_like(pos, e * c))             # e*c: drop
    tok = torch.arange(top_k * n, device=x.device) % n

    # the inverse plan: the token filling each (expert, capacity) slot,
    # 0 = empty.  Only the drop sentinel's slot ever takes two writes,
    # and it is cut off, so a nondeterministic index_put_ is harmless
    # here (nowhere else)
    src = torch.zeros(e * c + 1, dtype=torch.int64, device=x.device)
    src[dest] = tok + 1
    src = src[:e * c]
    filled = src > 0
    buf = torch.where(filled[:, None], x2[(src - 1).clamp_min(0)],
                      torch.zeros((), dtype=x2.dtype, device=x.device)
                      ).reshape(e, c, d)

    if ep > 1:
        buf = _Dispatch.apply(buf, expert_group)        # [E/ep, ep*C, D]
    buf = tp_lib.copy_to_group(buf, model_group)
    g = torch.bmm(buf, we_gate.to(buf.dtype))
    u = torch.bmm(buf, we_up.to(buf.dtype))
    out = torch.bmm(F.silu(g) * u, we_down.to(buf.dtype))
    out = tp_lib.reduce_from_group(out, model_group)
    if ep > 1:
        out = _Combine.apply(out, expert_group)         # [E, C, D]
    out_pad = torch.cat([out.reshape(e * c, d),
                         torch.zeros((1, d), dtype=out.dtype,
                                     device=out.device)])
    contrib = out_pad[dest].float()                     # dropped: zero row
    w = gates.t().reshape(-1) * keep                    # [k*N] fp32
    y = (contrib * w[:, None]).reshape(top_k, n, d).sum(dim=0)
    return y.to(x.dtype).reshape(b, t, d), aux
