"""The BSP gradient exchange: allreduce-mean over the process group.

Port of ``allreduce_mean`` and the flat bucket layout of
``theanompi_tpu/parallel/exchange.py`` onto ``torch.distributed``.
Where the JAX function returns a new tree, this one averages a list of
tensors IN PLACE (the gradients of an 8B-scale model are not copied).

- ``wire_dtype`` casts each buffer onto the wire (bf16 halves the
  bytes) and the mean is cast back, as ``(w / n).astype(orig)``.
- ``two_phase`` exchanges by ``reduce_scatter_tensor`` +
  ``all_gather_into_tensor`` (the reference's ``asa*`` ring shape);
  otherwise one ``all_reduce``.  The monolithic path keeps a one-call
  ``all_reduce`` for a tensor whose leading dim does not divide by the
  group size, as the JAX one does.
- ``bucket_elems > 0`` packs the tensors into buckets of one flat
  layout (``flat_layout``: at most ``MAX_EXCHANGE_BUCKETS``, each a
  multiple of the group size) and exchanges bucket by bucket, so the
  extra memory is one bucket.  A layout that fits one bucket degrades
  to the monolithic per-tensor path.

The exchange runs after the backward; overlapping buckets with it
(gradient hooks, as DDP does) is later work.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

MAX_EXCHANGE_BUCKETS = 64


def flat_layout(size: int, n_shards: int,
                bucket_elems: int = 0) -> tuple[int, int]:
    """``(padded, bucket_len)`` of a ``size``-element buffer sharded
    ``n_shards`` ways with target ``bucket_elems`` per bucket (the JAX
    package's rule); ``bucket_len == 0`` means monolithic.  The bucket
    count is capped at ``MAX_EXCHANGE_BUCKETS`` by growing the bucket."""
    padded = -(-size // n_shards) * n_shards
    if bucket_elems <= 0 or not size:
        return padded, 0
    min_elems = -(-size // MAX_EXCHANGE_BUCKETS)
    bucket_len = -(-max(int(bucket_elems), min_elems) // n_shards) * n_shards
    if bucket_len >= padded:
        return padded, 0
    return -(-size // bucket_len) * bucket_len, bucket_len


def _reduce(w: torch.Tensor, n: int, two_phase: bool, group) -> None:
    """Sum ``w`` (contiguous) over the group in place."""
    if two_phase and w.dim() and w.shape[0] % n == 0:
        flat = w.reshape(-1)
        part = torch.empty(flat.numel() // n, dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(part, flat, group=group)
        dist.all_gather_into_tensor(flat, part, group=group)
    else:
        dist.all_reduce(w, group=group)


def allreduce_mean(tensors: list[torch.Tensor], *, group=None,
                   wire_dtype=None, two_phase: bool = False,
                   bucket_elems: int = 0) -> None:
    """Replace each tensor by its mean over the group (see module
    docstring)."""
    n = dist.get_world_size(group)
    if bucket_elems:
        sizes = [t.numel() for t in tensors]
        size = sum(sizes)
        dtypes = {t.dtype for t in tensors}
        dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        padded, bucket_len = flat_layout(size, n, bucket_elems)
        if bucket_len:
            dev = tensors[0].device
            for lo in range(0, padded, bucket_len):
                hi = lo + bucket_len
                buf = torch.zeros(bucket_len, dtype=dtype, device=dev)
                spans, off = [], 0
                for t, sz in zip(tensors, sizes):
                    s, e = max(lo, off), min(hi, off + sz)
                    if e > s:
                        buf[s - lo:e - lo] = t.reshape(-1)[s - off:e - off]
                        spans.append((t, s - off, e - off, s - lo))
                    off += sz
                w = buf if wire_dtype is None else buf.to(wire_dtype)
                _reduce(w, n, two_phase, group)
                out = (w / n).to(dtype)
                for t, a, b, at in spans:
                    t.view(-1)[a:b] = out[at:at + b - a]
            return
    for t in tensors:
        w = t if wire_dtype is None else t.to(wire_dtype)
        if not w.is_contiguous():
            w = w.contiguous()
        _reduce(w, n, two_phase, group)
        t.copy_(w / n)
