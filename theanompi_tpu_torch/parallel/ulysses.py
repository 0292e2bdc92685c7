"""Ulysses sequence parallelism: attention over the seq axis of a
:class:`~theanompi_tpu_torch.parallel.mesh.Layout` by two head/sequence
all-to-alls.

Port of ``theanompi_tpu/parallel/ulysses.py``.  Where the ring keeps the
queries resident and moves K/V sp - 1 hops, Ulysses re-shards once each
way: an all-to-all turns the [B, H, T/sp, D] sequence shard into a
[B, H/sp, T, D] head shard, each rank runs ordinary full-sequence
attention over its heads (``ops.attention.flash_attention``: K1, K2 and
K3 on the card, their plain versions on the CPU), and a second
all-to-all restores the sequence shard.  ``heads_to_seq`` and
``seq_to_heads`` are autograd functions over ``all_to_all_single``; the
backward of each is the other.  GQA stays compact on the wire: K/V
move with H/kv_rep heads and are repeated only for the local compute.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from theanompi_tpu_torch.ops.attention import flash_attention


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` [sp, ...] over ``group``: chunk j
    goes to rank j; chunk i of the result came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group.device_group)
    return out


def _heads_to_seq(x, group):
    b, h, t, d = x.shape
    s = group.size
    x = x.reshape(b, s, h // s, t, d).transpose(0, 1)
    y = _a2a(x, group)                            # [s(src), b, h/s, t, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // s, s * t, d)


def _seq_to_heads(x, group):
    b, hs, tt, d = x.shape
    s = group.size
    x = x.reshape(b, hs, s, tt // s, d).permute(2, 0, 1, 3, 4)
    y = _a2a(x, group)                            # [s(src), b, h/s, t, d]
    return y.transpose(0, 1).reshape(b, s * hs, tt // s, d)


class HeadsToSeq(torch.autograd.Function):
    """[B, H, T/sp, D] sequence shard -> [B, H/sp, T, D] head shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


class SeqToHeads(torch.autograd.Function):
    """[B, H/sp, T, D] head shard -> [B, H, T/sp, D] sequence shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


def heads_to_seq(x, group):
    return x if group.size == 1 else HeadsToSeq.apply(x, group)


def seq_to_heads(x, group):
    return x if group.size == 1 else SeqToHeads.apply(x, group)


def ulysses_attention(q, k, v, group, *, causal: bool = True,
                      sm_scale: float | None = None, kv_rep: int = 1):
    """Attention over a sequence sharded on the seq ``group`` (a
    ``Layout.seq``).  q, k, v are this rank's shards [B, H, T/sp, D]
    (k, v with H/kv_rep heads); H and H/kv_rep must divide by sp.
    Returns this rank's output shard [B, H, T/sp, D]."""
    sp, h, hkv = group.size, q.shape[1], k.shape[1]
    if h % sp or hkv % sp:
        raise ValueError(
            f"ulysses needs heads divisible by the seq axis: H={h}, "
            f"H_kv={hkv}, sp={sp} (use sp_mode='ring' instead)")
    qh = heads_to_seq(q, group)                   # [B, H/sp, T, D]
    kh = heads_to_seq(k, group)                   # [B, Hkv/sp, T, D]
    vh = heads_to_seq(v, group)
    if kv_rep != 1:
        kh = kh.repeat_interleave(kv_rep, dim=1)
        vh = vh.repeat_interleave(kv_rep, dim=1)
    oh = flash_attention(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return seq_to_heads(oh, group)                # [B, H, T/sp, D]
