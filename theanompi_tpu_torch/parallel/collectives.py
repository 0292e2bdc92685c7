"""The permutation collective the layouts share: ``lax.ppermute``.

The ring attention's neighbour hop (``ring_attention.ring_shift``), the
pipeline's chain hop (``pp.chain_hop``) and the GoSGD push
(``exchange.gossip_push``) are each a permutation of a group's ranks.
:func:`ppermute` is one ``all_to_all_single`` whose splits are non-zero
only toward the rank's destination: one code path for NCCL and for gloo
(which takes CUDA tensors for it, e.g. for ranks sharing one card;
``send``/``recv`` it does not).  A rank that no one sends to receives
zeros, as under ``lax.ppermute``.  :func:`permute_all` packs the tensors
of each dtype into one buffer, one collective a dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``lax.ppermute``: under ``perm`` (``(src, dst)`` pairs of ranks of
    ``group``, each rank at most once a source and once a destination)
    rank ``dst`` receives ``x`` of rank ``src``; a rank no pair sends to
    receives zeros.  One ``all_to_all_single`` over the group."""
    s, r = group.size, group.rank
    to = {a: b for a, b in perm}
    frm = {b: a for a, b in perm}
    flat = x.contiguous().view(-1)
    n = flat.numel()
    send, recv = [0] * s, [0] * s
    if r in to:
        send[to[r]] = n
    if r in frm:
        recv[frm[r]] = n
    out = torch.empty(n if r in frm else 0, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, flat if r in to else flat[:0], recv, send,
                           group=group.device_group)
    ppermute.calls += 1
    return out.view(x.shape) if r in frm else torch.zeros_like(x)


ppermute.calls = 0


def permute_all(ts: list, group, perm) -> list:
    """:func:`ppermute` of every tensor of ``ts``, one collective for the
    tensors of each dtype (packed flat)."""
    out = list(ts)
    by_dtype: dict = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        got = ppermute(flat, group, perm)
        at = 0
        for i in idx:
            n = ts[i].numel()
            out[i] = got[at:at + n].view(ts[i].shape)
            at += n
    return out


def ring(size: int, step: int = 1) -> list:
    """The permutation rank r -> ``(r + step) % size``."""
    return [(i, (i + step) % size) for i in range(size)]
