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

The asynchronous rules' merges (``elastic_*`` for EASGD, ``gossip_*``
for GoSGD) are the JAX functions of the same names: plain tensor ops
over a leading worker axis ``W`` of stacked replicas, in one process,
on trees (dicts, lists, tuples) of tensors.  Like the JAX ones they
return new trees; integer leaves (a step counter) keep their local
value through a gossip merge.  ``gossip_push`` (a ``ppermute`` between
processes) belongs to the multi-process rules (ROADMAP.md A10).
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


# -- the asynchronous rules' merges -------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees of the same
    structure in ``rest`` (dicts, lists and tuples are nodes)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _tree_pair_map(pair, local, center):
    """``pair(w, c) -> (w', c')`` leafwise; returns two trees."""
    out = []
    tree_map(lambda a, b: out.append(pair(a, b)), local, center)
    first, second = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(first), local),
            tree_map(lambda _: next(second), local))


def _over_workers(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[W]`` vector shaped to broadcast over ``[W, ...]`` leaves."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def elastic_pair_update(local, center, alpha: float):
    """One elastic exchange (EASGD; Zhang et al. 2015): returns
    ``(new_local, new_center)`` with ``new_local = w_i - alpha*(w_i -
    w_c)`` and ``new_center = w_c + alpha*(w_i - w_c)``."""

    def pair(w_i, w_c):
        diff = alpha * (w_i - w_c)
        return w_i - diff, w_c + diff

    return _tree_pair_map(pair, local, center)


def elastic_center_merge(locals_stacked, center, alpha: float):
    """An EASGD round over stacked replicas: each worker pulls against
    the SAME center snapshot, then the center adds the summed pushes
    (the reference's server draining one cadence window of requests)."""

    def pair(w, c):
        diff = alpha * (w - c)                      # [W, ...]
        return w - diff, c + diff.sum(dim=0)

    return _tree_pair_map(pair, locals_stacked, center)


def elastic_center_merge_masked(locals_stacked, center, alpha: float,
                                mask: torch.Tensor):
    """An EASGD round in which only the workers with ``mask`` (``[W]``
    {0,1}) set exchange; the others keep training against a stale
    center (the out-of-step mode)."""

    def pair(w, c):
        m = _over_workers(mask.to(torch.float32), w.dim()).to(w.dtype)
        diff = alpha * (w - c) * m
        return w - diff, c + diff.sum(dim=0)

    return _tree_pair_map(pair, locals_stacked, center)


def _routing(scores, route, push_mask):
    """(kept scores, routing ``[W, W]``): pushing workers send half
    their score to ``route[s]``, ``routing[s, d]`` the score in flight
    from s to d."""
    w = scores.shape[0]
    sent = push_mask.to(scores.dtype) * scores * 0.5
    one_hot = torch.nn.functional.one_hot(route.long(), w).to(scores.dtype)
    return scores - sent, one_hot * sent[:, None]


def _score_merge(cur, payload, routing, own_scores, new_scores):
    """``(own*cur + routing^T payload) / new`` in fp32 over the worker
    axis; integer leaves keep their local value (workers advance them
    in lockstep)."""
    if not cur.is_floating_point():
        return cur
    f32 = cur.float()
    recv = torch.tensordot(routing, payload.float(), dims=([0], [0]))
    own = _over_workers(own_scores, f32.dim()) * f32
    tot = _over_workers(new_scores, f32.dim())
    return ((own + recv) / tot).to(cur.dtype)


def gossip_matrix_round(stacked_params, scores, route, push_mask):
    """One GoSGD round (Blot et al. 2016) over stacked replicas, as a
    score-weighted routing contraction: worker s pushes iff
    ``push_mask[s]`` to ``route[s]``, halving its score; each receiver
    merges every payload that reached it, weighted by the scores, and
    adds them.  Returns ``(merged, new_scores)``."""
    kept, routing = _routing(scores, route, push_mask)
    new_scores = kept + routing.sum(dim=0)
    merged = tree_map(
        lambda p: _score_merge(p, p, routing, kept, new_scores),
        stacked_params)
    return merged, new_scores


def gossip_send(scores, route, push_mask):
    """Send side of a (possibly delayed) gossip round: pushing workers
    halve their score now; returns ``(new_scores, routing)``."""
    return _routing(scores, route, push_mask)


def gossip_deliver(stacked_params, scores, stale_params, routing):
    """Receive side: merge the payloads in flight (``stale_params``, the
    senders' snapshot taken at ``gossip_send``) into the current
    replicas.  Returns ``(merged, new_scores)``."""
    new_scores = scores + routing.sum(dim=0)
    merged = tree_map(
        lambda cur, st: _score_merge(cur, st, routing, scores, new_scores),
        stacked_params, stale_params)
    return merged, new_scores


def gossip_merge(params_a, score_a, params_b, score_b):
    """Score-weighted merge of two models: ``w = (s_a*w_a + s_b*w_b) /
    (s_a + s_b)``, ``s = s_a + s_b``."""
    total = score_a + score_b
    merged = tree_map(
        lambda a, b: ((score_a * a + score_b * b) / total).to(a.dtype),
        params_a, params_b)
    return merged, total
