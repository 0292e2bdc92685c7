"""The BSP gradient exchange over the process group: allreduce-mean,
the flat layout, the compressed wire and ZeRO-1.

Port of ``allreduce_mean``, the flat-buffer machinery, the quantized
wire and ``scatter_update_gather`` of
``theanompi_tpu/parallel/exchange.py`` onto ``torch.distributed``.
Where the JAX functions return new trees, these work on LISTS of
tensors in one order and write their results IN PLACE (the gradients
and parameters of an 8B-scale model are not copied whole).

- ``allreduce_mean``: ``wire_dtype`` casts each buffer onto the wire
  (bf16 halves the bytes) and the mean is cast back, as ``(w /
  n).astype(orig)``; ``two_phase`` exchanges by
  ``reduce_scatter_tensor`` + ``all_gather_into_tensor`` (the
  reference's ``asa*`` ring shape), otherwise one ``all_reduce``.  The
  monolithic path keeps a one-call ``all_reduce`` for a tensor whose
  leading dim does not divide by the group size, as the JAX one does.
- The flat layout (``FlatSpec``, ``flat_spec``, ``flat_pack``,
  ``flat_pack_bucket``, ``flat_unpack``): every tensor raveled and
  concatenated into one buffer, zero-padded so it shards evenly over
  the group, optionally tiled into at most ``MAX_EXCHANGE_BUCKETS``
  equal buckets (``bucket_elems > 0``).  A bucket reads only the
  tensors it covers, so the extra memory of a bucketed exchange is a
  bucket.  A layout that fits one bucket is the monolithic one.
- The compressed wire (``exch_compression`` int8 / fp8 e4m3):
  ``quantize_chunks`` gives each chunk one symmetric f32 scale; the
  reduce-scatter is an ``all_to_all_single`` of the 1-byte chunks and
  one of the ``[n]`` scales, each sender's chunk decoded by its scale
  and summed in f32 in rank order; the all-gather ships the reduced
  shard's bytes and scale the same way.  ``compressed_allreduce_mean``
  carries the error-feedback residuals ``r1`` (local gradient) and
  ``r2`` (the reduced shard).
- ZeRO-1 (``scatter_update_gather``): reduce-scatter the packed
  gradients (optionally on the ``wire_dtype`` wire, or compressed with
  ``r1``), run the optimizer on this rank's flat shard, all-gather the
  updated shard in the MASTER dtype.  Bucketed, each shard is
  bucket-major, the layout ``utils/reshard.py`` permutes.

The tensors handed to the flat functions may be views in another
layout than their storage (the classifiers pass their conv and FC
weights in the JAX layout), so the flat order and contents are the JAX
package's: a zero1 optimizer shard or an EF residual crosses between
the packages in a checkpoint.

The collectives are ``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor`` and ``all_to_all_single``: NCCL on cards,
gloo on the CPU, and gloo on CUDA tensors for ranks that share one card
(NCCL refuses two ranks on one device), which takes all four.

The exchange runs after the backward; overlapping buckets with it
(gradient hooks, as DDP does) is later work.

The asynchronous rules' merges (``elastic_*`` for EASGD, ``gossip_*``
for GoSGD) are the JAX functions of the same names: plain tensor ops
over a leading worker axis ``W`` of stacked replicas, in one process,
on trees (dicts, lists, tuples) of tensors.  Like the JAX ones they
return new trees; integer leaves (a step counter) keep their local
value through a gossip merge.  ``gossip_push`` is the JAX one-round
push between processes: a ``ppermute`` over a permutation of the ranks
of a group (``collectives.permute_all``: one ``all_to_all_single`` a
dtype), then the score-weighted merge.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from theanompi_tpu_torch.obs.profiler import scope

from theanompi_tpu_torch.parallel.collectives import permute_all

MAX_EXCHANGE_BUCKETS = 64


def _reduce(w: torch.Tensor, n: int, two_phase: bool, group) -> None:
    """Sum ``w`` (contiguous) over the group in place; a one-rank group
    (a layout's data axis of one replica) holds the sum already, so
    no collective runs (gloo would stage ``w`` through the host)."""
    if n == 1:
        return
    if two_phase and w.dim() and w.shape[0] % n == 0:
        flat = w.reshape(-1)
        part = torch.empty(flat.numel() // n, dtype=w.dtype, device=w.device)
        dist.reduce_scatter_tensor(part, flat, group=group)
        dist.all_gather_into_tensor(flat, part, group=group)
    else:
        dist.all_reduce(w, group=group)


# -- the flat layout -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Layout of a list of tensors packed into one padded flat buffer:
    ``padded`` is ``size`` rounded up to ``n_shards`` (and to a whole
    number of buckets when ``bucket_len > 0``; 0 = monolithic)."""

    shapes: tuple
    dtypes: tuple
    dtype: torch.dtype       # buffer dtype (the optimizer's master width)
    size: int                # live elements
    padded: int
    n_shards: int
    bucket_len: int = 0

    @property
    def shard_len(self) -> int:
        return self.padded // self.n_shards

    @property
    def n_buckets(self) -> int:
        return self.padded // self.bucket_len if self.bucket_len else 1

    @property
    def bucket_shard_len(self) -> int:
        """A rank's elements of ONE bucket's reduce-scatter shard."""
        return (self.bucket_len or self.padded) // self.n_shards


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


def flat_spec(tensors, n_shards: int, dtype=None, *,
              bucket_elems: int = 0) -> FlatSpec:
    """Layout for packing ``tensors`` into one buffer sharded
    ``n_shards`` ways; ``dtype`` defaults to the common dtype (fp32
    when they disagree)."""
    shapes = tuple(tuple(t.shape) for t in tensors)
    dtypes = tuple(t.dtype for t in tensors)
    if dtype is None:
        dtype = dtypes[0] if len(set(dtypes)) == 1 else torch.float32
    size = sum(math.prod(s) for s in shapes)
    padded, bucket_len = flat_layout(size, n_shards, bucket_elems)
    return FlatSpec(shapes, dtypes, dtype, size, padded, int(n_shards),
                    bucket_len)


def _spans(spec: FlatSpec, lo: int, hi: int):
    """``(index, start, end, at)`` of every tensor overlapping pack
    elements ``[lo, hi)``: its elements ``[start, end)`` sit at
    ``[at, at + end - start)`` of the range."""
    off = 0
    for i, shape in enumerate(spec.shapes):
        n = math.prod(shape)
        s, e = max(lo, off), min(hi, off + n)
        if e > s:
            yield i, s - off, e - off, s - lo
        off += n
        if off >= hi:
            return


def flat_pack_range(tensors, spec: FlatSpec, lo: int,
                    hi: int) -> torch.Tensor:
    """Pack elements ``[lo, hi)`` of the padded buffer (the pad is
    zeros), read only from the tensors that overlap them."""
    out = torch.zeros(hi - lo, dtype=spec.dtype, device=tensors[0].device)
    for i, a, b, at in _spans(spec, lo, hi):
        out[at:at + b - a] = tensors[i].reshape(-1)[a:b]
    return out


def flat_pack(tensors, spec: FlatSpec) -> torch.Tensor:
    """Every raveled tensor (+ zero pad) as one ``[spec.padded]``."""
    return flat_pack_range(tensors, spec, 0, spec.padded)


def flat_pack_bucket(tensors, spec: FlatSpec, i: int) -> torch.Tensor:
    """Bucket ``i`` of the packed buffer, built from the tensors that
    overlap it only."""
    bl = spec.bucket_len or spec.padded
    return flat_pack_range(tensors, spec, i * bl, (i + 1) * bl)


@torch.no_grad()
def flat_unpack_range(buf: torch.Tensor, spec: FlatSpec, lo: int,
                      tensors) -> None:
    """Write ``buf`` (pack elements ``[lo, lo + len(buf))``) into the
    tensors it covers, cast to their dtypes; the pad is dropped."""
    for i, a, b, at in _spans(spec, lo, lo + buf.shape[0]):
        t = tensors[i]
        src = buf[at:at + b - a]
        if t.is_contiguous():
            t.view(-1)[a:b] = src
        else:
            # a view in another layout (a JAX-layout weight): write the
            # whole tensor through it, keeping the elements past a
            # bucket edge that splits it
            if (a, b) != (0, t.numel()):
                full = t.reshape(-1).clone()
                full[a:b] = src
                src = full
            t.copy_(src.view(t.shape))


def flat_unpack(buf: torch.Tensor, spec: FlatSpec) -> list[torch.Tensor]:
    """Inverse of :func:`flat_pack`: new tensors of the spec's shapes
    and dtypes (the pad dropped)."""
    out, off = [], 0
    for shape, dt in zip(spec.shapes, spec.dtypes):
        n = math.prod(shape)
        out.append(buf[off:off + n].reshape(shape).to(dt))
        off += n
    return out


def allreduce_mean(tensors: list[torch.Tensor], *, group=None,
                   wire_dtype=None, two_phase: bool = False,
                   bucket_elems: int = 0) -> None:
    """Replace each tensor by its mean over the group (see module
    docstring)."""
    n = dist.get_world_size(group)
    if bucket_elems:
        spec = flat_spec(tensors, n, bucket_elems=bucket_elems)
        if spec.n_buckets > 1:
            for i in range(spec.n_buckets):
                # one profiler range a bucket (obs/profiler.py's legs)
                with scope(f"exchange_b{i}"):
                    buf = flat_pack_bucket(tensors, spec, i)
                    w = buf if wire_dtype is None else buf.to(wire_dtype)
                    _reduce(w, n, two_phase, group)
                    flat_unpack_range((w / n).to(spec.dtype), spec,
                                      i * spec.bucket_len, tensors)
            return
    # the monolithic exchange is "bucket 0" to the profiler
    with scope("exchange_b0"):
        for t in tensors:
            w = t if wire_dtype is None else t.to(wire_dtype)
            if not w.is_contiguous():
                w = w.contiguous()
            _reduce(w, n, two_phase, group)
            t.copy_(w / n)


# -- the compressed wire with error feedback -----------------------------------

#: wire codecs: name -> (wire dtype, the symmetric qmax a chunk's amax
#: maps onto).  fp8 is e4m3 with its largest finite value 448.
WIRE_COMPRESSIONS: dict = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def quantize_chunks(chunks: torch.Tensor, compression: str):
    """Symmetric per-chunk quantization: ``chunks`` ``[C, L]`` float ->
    ``(wire [C, L] 1-byte, scales [C] f32)`` with ``scale = amax/qmax``
    (an all-zero chunk gets scale 1, so its wire stays 0).  int8 rounds
    half to even and clips to +-qmax; fp8 rounds to nearest even (the
    chunk's values lie within +-448 by the scale)."""
    wire_dtype, qmax = WIRE_COMPRESSIONS[compression]
    c32 = chunks.to(torch.float32)
    amax = c32.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / qmax,
                        torch.ones_like(amax)).to(torch.float32)
    y = c32 / scale[:, None]
    if compression == "int8":
        wire = torch.clamp(torch.round(y), -qmax, qmax).to(wire_dtype)
    else:
        wire = y.to(wire_dtype)
    return wire, scale


def dequantize_chunks(wire: torch.Tensor, scales: torch.Tensor):
    """Inverse of :func:`quantize_chunks` -> f32 ``[C, L]``; every
    receiver decodes a chunk to the values the sender's own decode
    sees (the identity the error-feedback residual rests on)."""
    return wire.to(torch.float32) * scales[:, None]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The 1-byte wire as uint8 (collectives take no fp8 dtype)."""
    return t.view(torch.uint8)


def _compressed_reduce_scatter(buf: torch.Tensor, n: int, compression: str,
                               group) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized reduce-scatter of ``buf`` ``[len]`` (len % n == 0):
    ``(sum_shard [len/n] f32, decoded [len] f32)``, ``decoded`` this
    rank's contribution as every receiver decodes it.  One
    ``all_to_all_single`` of the 1-byte chunks (chunk d to rank d) and
    one of the ``[n]`` scales; each sender's chunk decoded by its scale
    and summed in f32 in rank order."""
    chunks = buf.to(torch.float32).reshape(n, -1)
    with scope("quantize_wire"):
        wire, scales = quantize_chunks(chunks, compression)
    with scope("dequantize_wire"):
        decoded = dequantize_chunks(wire, scales).reshape(-1)
    wr = torch.empty_like(wire)
    sr = torch.empty_like(scales)
    dist.all_to_all_single(_bytes(wr), _bytes(wire), group=group)
    dist.all_to_all_single(sr, scales, group=group)
    with scope("dequantize_wire"):
        parts = dequantize_chunks(wr, sr)
    shard = parts[0].clone()
    for j in range(1, n):
        shard += parts[j]
    return shard, decoded


def _compressed_all_gather(shard: torch.Tensor, n: int, compression: str,
                           group) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized all-gather of ``shard`` ``[L]``: ``(full [n*L] f32,
    decoded [L] f32)``.  Every rank decodes ``full`` from the same
    gathered bytes and scales, so the replicas agree bit for bit."""
    with scope("quantize_wire"):
        wire, scales = quantize_chunks(shard[None, :], compression)
    with scope("dequantize_wire"):
        decoded = dequantize_chunks(wire, scales)[0]
    wg = torch.empty((n * wire.shape[1],), dtype=wire.dtype,
                     device=wire.device)
    sg = torch.empty((n,), dtype=torch.float32, device=wire.device)
    dist.all_gather_into_tensor(_bytes(wg), _bytes(wire[0]), group=group)
    dist.all_gather_into_tensor(sg, scales, group=group)
    with scope("dequantize_wire"):
        full = dequantize_chunks(wg.reshape(n, -1), sg).reshape(-1)
    return full, decoded


def compressed_allreduce_mean(tensors: list[torch.Tensor], *,
                              compression: str,
                              r1: torch.Tensor | None = None,
                              r2: torch.Tensor | None = None,
                              bucket_elems: int = 0, group=None):
    """Mean-allreduce with a quantized wire in both phases (the
    reduce-scatter of the gradients, the all-gather of the reduced
    shard), bucket by bucket with ``bucket_elems``.  The tensors take
    their means in place.  ``r1`` ``[spec.padded]`` f32 is this rank's
    residual of the local compression (added before quantizing), ``r2``
    ``[spec.shard_len]`` f32 (bucket-major when bucketed) the
    shard-owner residual of the mean's compression; each is updated in
    place to the error this exchange made, and ``None`` drops the error
    (plain QSGD)."""
    n = dist.get_world_size(group)
    spec = flat_spec(tensors, n, bucket_elems=bucket_elems)
    bl = spec.bucket_len or spec.padded
    bs = spec.bucket_shard_len
    for i in range(spec.n_buckets):
        # the bucket's range; the codec's nested ranges win inside it
        with scope(f"exchange_b{i}"):
            g = flat_pack_bucket(tensors, spec, i).to(torch.float32)
            if r1 is not None:
                g = g + r1[i * bl:(i + 1) * bl]
            shard_sum, dec1 = _compressed_reduce_scatter(g, n, compression,
                                                         group)
            if r1 is not None:
                r1[i * bl:(i + 1) * bl] = g - dec1
            m = shard_sum / n
            if r2 is not None:
                m = m + r2[i * bs:(i + 1) * bs]
            full, dec2 = _compressed_all_gather(m, n, compression, group)
            if r2 is not None:
                r2[i * bs:(i + 1) * bs] = m - dec2
            flat_unpack_range(full.to(spec.dtype), spec, i * bl, tensors)


# -- ZeRO-1: the optimizer on this rank's flat shard ---------------------------

def _slice_shard_state(state, spec: FlatSpec, i: int):
    """Bucket ``i``'s rows of a shard-shaped optimizer state (views, so
    an in-place update writes the shard): flat ``[shard_len]`` tensors
    slice to ``[bucket_shard_len]``; a scalar (Adam's ``t``) passes."""
    bs = spec.bucket_shard_len

    def one(x):
        if isinstance(x, torch.Tensor) and x.dim() \
                and x.shape[0] == spec.shard_len:
            return x[i * bs:(i + 1) * bs]
        return x

    if isinstance(state, dict):
        return {k: _slice_shard_state(v, spec, i) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_slice_shard_state(v, spec, i) for v in state)
    return one(state)


def _concat_shard_state(state, parts: list, spec: FlatSpec):
    """Inverse of :func:`_slice_shard_state` after the per-bucket
    updates: the flat tensors were written in place through the views;
    a scalar is the same in every bucket (each computed it from the same
    input), and the first bucket's is kept."""
    if isinstance(state, dict):
        return {k: _concat_shard_state(v, [p[k] for p in parts], spec)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_concat_shard_state(v, [p[j] for p in parts],
                                               spec)
                           for j, v in enumerate(state))
    if isinstance(state, torch.Tensor) and state.dim() \
            and state.shape[0] == spec.shard_len:
        return state
    return parts[0]


@torch.no_grad()
def scatter_update_gather(params: list[torch.Tensor],
                          grads: list[torch.Tensor], opt_update, *,
                          spec: FlatSpec, opt_state=None, wire_dtype=None,
                          compression: str | None = None,
                          r1: torch.Tensor | None = None, group=None):
    """ZeRO-1 exchange and update; the parameters take their new values
    in place.  Bucket by bucket (one bucket when monolithic):

    1. reduce-scatter the bucket of packed gradients: this rank ends
       with the MEAN of its 1/N of it (on the ``wire_dtype`` wire, or
       quantized with ``compression`` and the residual ``r1``
       ``[spec.padded]``, which is updated in place);
    2. ``opt_update(p_shard, g_shard, state) -> state`` updates this
       rank's parameter shard in place (the shard-shaped optimizer
       state, sliced to the bucket's rows);
    3. all-gather the updated shards in the master dtype and unpack them
       into ``params``.

    This rank's shard is bucket-major: bucket i's 1/N rows at ``[i*bs,
    (i+1)*bs)``.  The buckets are independent (each reads and writes
    only its own elements), so running each to its end before the next
    keeps the extra memory at one bucket.  Returns the new state."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if spec.n_shards != n:
        raise ValueError(f"flat spec for {spec.n_shards} shards, group "
                         f"of {n}")
    bl = spec.bucket_len or spec.padded
    bs = spec.bucket_shard_len
    dev = params[0].device
    parts = []
    for i in range(spec.n_buckets):
        # the bucket's range; the update's (and the codec's) nested
        # ranges win inside it
        with scope(f"exchange_b{i}"):
            gb = flat_pack_bucket(grads, spec, i)
            if compression is not None:
                g32 = gb.to(torch.float32)
                if r1 is not None:
                    g32 = g32 + r1[i * bl:(i + 1) * bl]
                g_sum, dec = _compressed_reduce_scatter(g32, n, compression,
                                                        group)
                if r1 is not None:
                    r1[i * bl:(i + 1) * bl] = g32 - dec
                g_shard = (g_sum / n).to(spec.dtype)
            else:
                w = gb if wire_dtype is None else gb.to(wire_dtype)
                gs = torch.empty(bs, dtype=w.dtype, device=dev)
                dist.reduce_scatter_tensor(gs, w, group=group)
                g_shard = gs.to(spec.dtype) / n
            del gb
            lo = i * bl + me * bs
            p_shard = flat_pack_range(params, spec, lo, lo + bs)
            with scope("opt_update"):
                parts.append(opt_update(
                    p_shard, g_shard, opt_state if spec.n_buckets == 1
                    else _slice_shard_state(opt_state, spec, i)))
            full = torch.empty(bl, dtype=spec.dtype, device=dev)
            dist.all_gather_into_tensor(full, p_shard.to(spec.dtype),
                                        group=group)
            flat_unpack_range(full, spec, i * bl, params)
    if spec.n_buckets == 1:
        return parts[0]
    return _concat_shard_state(opt_state, parts, spec)


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


def gossip_push(params, score: torch.Tensor, *, group, perm, pushing):
    """One GoSGD round between the ranks of ``group`` (an object with
    ``rank``, ``size`` and ``device_group``, e.g. a layout axis):
    ``perm`` is a (src, dst) permutation sampled on the host, the same
    on every rank; ``pushing`` a ``[size]`` {0, 1} mask (1 = the rank
    pushes this round).  A pushing rank halves its score and its
    (params, score/2) travel to its ``perm`` destination, which merges
    them weighted by the scores; a rank that does not push sends score
    0, so its payload vanishes in the merge, and one permutation (one
    collective a dtype) carries the sparse push.  ``params`` is a tree
    of tensors; returns ``(merged, new score)`` as the JAX
    ``gossip_push``."""
    my_push = pushing[group.rank].to(score.dtype)
    sent_score = my_push * score * 0.5          # what travels
    new_score = score - sent_score              # halved iff pushing
    leaves = []
    tree_map(leaves.append, params)
    got = iter(permute_all([sent_score.reshape(1)] + leaves, group, perm))
    recv_score = next(got).reshape(score.shape)
    total = new_score + recv_score

    def merge(mine):
        theirs = next(got)
        # (new·mine + recv·theirs) / total, the first product fused into
        # the add as XLA contracts it (one rounding): bitwise JAX's
        w = torch.addcmul(recv_score * theirs, new_score, mine) / total
        return w.to(mine.dtype)

    return tree_map(merge, params), total
