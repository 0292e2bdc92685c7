"""Ring attention: sequence parallelism over the seq axis of a
:class:`~theanompi_tpu_torch.parallel.mesh.Layout`.

Port of ``theanompi_tpu/parallel/ring_attention.py``.  Each rank holds a
contiguous sequence shard of Q, K and V ([B, H, T/sp, D]); the K/V pair
travels around the ring, one neighbour hop a step (rank r sends to
r + 1 and receives from r - 1), and every rank folds the visiting block
into its own queries' carry.

- ``impl="flash"`` (the default) is the :class:`RingFlash` autograd
  function.  Its forward runs ``flash_attention_fwd`` (kernel K1 on the
  card, its plain version on the CPU) a hop, causal only on hop 0 (the
  diagonal block; earlier blocks are full), and merges the (o, lse)
  pairs in f32.  Its backward runs ``flash_bwd`` (K2/K3) a hop against
  the GLOBAL (lse, delta = rowsum(dO·O)) and sends the f32 dK/dV
  accumulators around the ring with the K/V blocks, so each block's
  gradient lands back on its owner with every rank's share summed.
- ``impl="dense"`` folds each block with
  ``ops.attention.block_attn_update`` under plain autograd, the hop a
  differentiable shift (its backward shifts the other way).

GQA: K and V circulate compact (H/kv_rep heads: the hop's bytes); only
the visiting block is repeated to H heads for the fold, and the
repeated heads' dK/dV are summed back (``_unrep``).

Causality: a block from a later shard is invisible to every query of
this rank.  JAX, one SPMD program, computes such a hop and masks it to
exact zeros; here a rank skips that hop's kernel launches, with the
same result, but still runs the hop's collective, so every rank of
the seq group runs the same collectives in the same order.

The hop is ``collectives.ppermute`` over the ring ``r -> (r + 1) %
sp``: one ``all_to_all_single`` whose splits are non-zero only toward
that rank, one code path for NCCL and for gloo (which takes CUDA
tensors for it, e.g. for ranks sharing one card).
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch.ops.attention import (
    block_attn_finish,
    block_attn_init,
    block_attn_update,
    flash_attention_fwd,
    flash_bwd,
)
from theanompi_tpu_torch.parallel.collectives import (
    permute_all,
    ppermute,
    ring,
)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """``x`` of rank ``(r - step) % sp`` of the seq ``group`` (rank r
    sends its own to ``(r + step) % sp``); ``x`` itself at sp = 1."""
    if group.size == 1:
        return x
    return ppermute(x, group, ring(group.size, step))


def _shift_all(ts: list, group) -> list:
    """Every tensor of ``ts`` one hop around the ring, one collective for
    the tensors of each dtype (packed flat)."""
    return permute_all(ts, group, ring(group.size))


class _RingShift(torch.autograd.Function):
    """A differentiable hop: the gradient hops back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -1), None


def _rep(x, r: int):
    return x.repeat_interleave(r, dim=1) if r != 1 else x


def _unrep(dx, r: int):
    """The compact heads' gradient: the repeated groups' gradients
    summed (the transpose of ``_rep``)."""
    if r == 1:
        return dx
    b, hr, t, d = dx.shape
    return dx.reshape(b, hr // r, r, t, d).sum(dim=2)


def _hop_visible(my_idx: int, src: int, causal: bool) -> bool:
    """Whether the block that started on rank ``src`` is visible at all
    to rank ``my_idx``'s queries."""
    return not causal or src <= my_idx


class RingFlash(torch.autograd.Function):
    """See the module docstring (``impl="flash"``)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale, kv_rep):
        s, me = group.size, group.rank
        b, h, t_loc, d = q.shape
        f32 = dict(dtype=torch.float32, device=q.device)
        m = torch.full((b, h, t_loc), -torch.inf, **f32)
        num = torch.zeros((b, h, t_loc, d), **f32)
        den = torch.zeros((b, h, t_loc), **f32)
        k_cur, v_cur = k, v
        for step in range(s):
            src = (me - step) % s
            if _hop_visible(me, src, causal):
                o_i, lse_i = flash_attention_fwd(
                    q, _rep(k_cur, kv_rep), _rep(v_cur, kv_rep),
                    causal=causal and step == 0, sm_scale=sm_scale)
                # the diagonal hop folds first: exp(m - m_new) is 0 there
                m_new = torch.maximum(m, lse_i)
                alpha = torch.exp(m - m_new)
                w = torch.exp(lse_i - m_new)
                num = num * alpha[..., None] + w[..., None] * o_i.float()
                den = den * alpha + w
                m = m_new
            if step != s - 1:
                k_cur, v_cur = _shift_all([k_cur, v_cur], group)
        den = torch.clamp_min(den, 1e-30)
        o = (num / den[..., None]).to(q.dtype)
        lse = m + torch.log(den)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        ctx.sm_scale, ctx.kv_rep = sm_scale, kv_rep
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal, rep = ctx.group, ctx.causal, ctx.kv_rep
        s, me = group.size, group.rank
        delta = (g.float() * o.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_cur = torch.zeros_like(dk_cur)
        k_cur, v_cur = k, v
        for step in range(s):
            src = (me - step) % s
            if _hop_visible(me, src, causal):
                dq_i, dk_i, dv_i = flash_bwd(
                    q, _rep(k_cur, rep), _rep(v_cur, rep), g, lse, delta,
                    causal=causal and step == 0, sm_scale=ctx.sm_scale)
                dq += dq_i.float()
                dk_cur += _unrep(dk_i.float(), rep)
                dv_cur += _unrep(dv_i.float(), rep)
            # the accumulators ride the full ring (s hops) and land on
            # their block's owner; the blocks need s - 1
            if step != s - 1:
                k_cur, v_cur, dk_cur, dv_cur = _shift_all(
                    [k_cur, v_cur, dk_cur, dv_cur], group)
            else:
                dk_cur, dv_cur = _shift_all([dk_cur, dv_cur], group)
        return (dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype),
                None, None, None, None)


def _ring_dense(q, k, v, group, causal, sm_scale, kv_rep):
    s, me = group.size, group.rank
    b, h, t_loc, d = q.shape
    ar = torch.arange(t_loc, device=q.device)
    q_pos = me * t_loc + ar if causal else None
    carry = block_attn_init(b, h, t_loc, d, q.device)
    k_cur, v_cur = k, v
    for step in range(s):
        src = (me - step) % s
        k_pos = src * t_loc + ar if causal else None
        carry = block_attn_update(carry, q, _rep(k_cur, kv_rep),
                                  _rep(v_cur, kv_rep), q_pos=q_pos,
                                  k_pos=k_pos, sm_scale=sm_scale)
        if step != s - 1:        # the last fold feeds no hop
            k_cur = _RingShift.apply(k_cur, group)
            v_cur = _RingShift.apply(v_cur, group)
    return block_attn_finish(carry, q.dtype)


def ring_attention(q, k, v, group, *, causal: bool = True,
                   sm_scale: float | None = None, kv_rep: int = 1,
                   impl: str = "flash"):
    """Attention over a sequence sharded on the seq ``group`` (a
    ``Layout.seq``: ``rank``, ``size``, ``device_group``).  q, k, v are
    this rank's shards [B, H, T/sp, D] (k, v with H/kv_rep heads);
    returns this rank's output shard [B, H, T/sp, D].  ``impl``:
    ``"flash"`` (:class:`RingFlash`) or ``"dense"``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if impl == "flash":
        return RingFlash.apply(q, k, v, group, causal, sm_scale, kv_rep)
    if impl == "dense":
        return _ring_dense(q, k, v, group, causal, sm_scale, kv_rep)
    raise ValueError(f"impl must be 'flash' or 'dense', got {impl!r}")
