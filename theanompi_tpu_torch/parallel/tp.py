"""Tensor-parallel building blocks.

Port of ``theanompi_tpu/parallel/tp.py``.  The JAX functions run inside
``shard_map`` and reduce over the ``model`` mesh axis; here each rank
is a process and the model axis is a :class:`~theanompi_tpu_torch.
parallel.mesh.ModelGroup` passed as ``group``.  With ``group=None``
(tp = 1) the collectives are identities and every function is the
plain one-shard expression: the column- and row-parallel products are
``x @ w`` and the samplers act on the full vocab row.  With a group
(serving and training at tp > 1):

- :func:`copy_to_group` and :func:`reduce_from_group` are the two
  conjugate autograd functions the JAX package gets from the psum/pvary
  transposes under ``check_vma=True``: the first is the identity
  forward and an all-reduce backward (the replicated input of a
  column-parallel product: each rank's dx is a partial), the second an
  all-reduce forward and the identity backward;
- :func:`row_parallel` sums the ranks' partial products in the compute
  dtype (``lax.psum(x @ w.astype(x.dtype))``), through
  :func:`reduce_from_group`;
- :func:`embed_lookup` reads the rank's rows of the vocab-sharded table
  (misses give zeros) and sums them, the same way;
- :func:`sharded_argmax` takes the MAX of the ranks' maxima, then the
  MIN of the global ids that reach it, so ties go to the lowest global
  id within and across shards: tp = 1 and tp = 2 pick the same token;
- :func:`sharded_sample` draws the Gumbel noise for the FULL vocab from
  the row's generator and keeps the rank's columns, so sampled ids do
  not depend on tp.

The argmax keeps the JAX package's tie-break (lowest id:
``torch.argmax`` returns the first maximum).

The two fused LM heads (``chunked_unembed_xent``, ``dense_unembed_xent``)
are ``torch.autograd.Function``s with the JAX custom VJPs' manual
backwards: dlogits cast to the compute dtype before the dW and dx
products, which accumulate and return in f32 (``_mm_f32``).  With a
group the lse and the target logit are reduced over the vocab shards
and the backward sums dx over the group (the head's replicated input,
as ``_reduce_ct_to_primal`` does in JAX).  The metrics
(``sharded_softmax_xent``, ``sharded_top1_err``, ``sharded_topk_err``)
take the group the same way.

:func:`grad_sync` is the JAX spec-aware mean over the axes a leaf is
replicated on, for hand-built per-shard gradients only.

Sampling draws Gumbel noise for the full vocab from a
``torch.Generator`` seeded per row by the caller (request seed folded
with the token position, see :func:`fold_seed`), so a row's draw
depends only on its own seed and position: batched equals single.
These are not ``jax.random``'s bits and are not meant to be.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_MASK64 = (1 << 64) - 1


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    dist.all_reduce(t, op=op, group=group.device_group)
    return t


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial input
    gradients over the group (the transpose of JAX's implicit pvary)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce (SUM) forward; identity backward (the transpose of
    ``lax.psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group=None):
    """``x`` unchanged; its gradient summed over ``group`` (a no-op
    without one)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group=None):
    """``x`` summed over ``group`` (in place on a fresh tensor); the
    gradient passes through."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def vocab_shard_info(vocab: int, group=None) -> tuple[int, int]:
    """(local vocab size, first global id) of this rank's shard."""
    if group is None:
        return vocab, 0
    v_loc = vocab // group.size
    return v_loc, group.rank * v_loc


def col_parallel(x, w):
    """[..., D] x [D, F/tp] -> [..., F/tp]; no communication."""
    return x @ w.to(x.dtype)


def row_parallel(x, w, group=None):
    """[..., F/tp] x [F/tp, D] -> [..., D]: the partial product, summed
    over the model group in the compute dtype."""
    return reduce_from_group(x @ w.to(x.dtype), group)


def embed_lookup(ids, table, vocab: int, group=None):
    """Embedding rows for global ``ids`` from this rank's rows of the
    vocab-sharded ``table`` [V/tp, D]; ids outside the shard (or outside
    [0, vocab)) give zero vectors, and the sum over the group assembles
    the full vectors."""
    v_loc, off = vocab_shard_info(vocab, group)
    local = ids - off
    hit = (local >= 0) & (local < v_loc)
    safe = local.clamp(0, v_loc - 1).long()
    vecs = table[safe] * hit[..., None].to(table.dtype)
    return reduce_from_group(vecs, group)


def sharded_argmax(score, vocab: int, group=None):
    """Global argmax over a vocab-sharded score row [..., V/tp]; ties
    break to the lowest global id, within a shard and across shards."""
    if group is None:
        return torch.argmax(score, dim=-1)
    v_loc, off = vocab_shard_info(vocab, group)
    loc_max = score.amax(dim=-1)
    loc_arg = torch.argmax(score, dim=-1) + off
    gmax = _all_reduce(loc_max.clone(), group, dist.ReduceOp.MAX)
    cand = torch.where(loc_max >= gmax, loc_arg,
                       torch.full_like(loc_arg, vocab))
    return _all_reduce(cand, group, dist.ReduceOp.MIN)


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed derived from (seed, data) by the splitmix64 mix —
    the port's counterpart of ``jax.random.fold_in``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def gumbel(seed: int, n: int, device) -> torch.Tensor:
    """[n] f32 Gumbel(0, 1) noise from a generator seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sharded_sample(logits, vocab: int, seeds, temperature, group=None):
    """One token id per row from vocab-sharded logits [N, V/tp].
    ``seeds``: N host ints, one per row, already folded with the row's
    position; ``temperature`` [N] f32.  Rows at temperature <= 0 decode
    greedily; the rest take ``argmax(logits / T + g)`` with Gumbel noise
    g, an exact draw from ``softmax(logits / T)``.  The noise is drawn
    for the full vocab and sliced to this rank's columns, so the ids
    are the same at any tp."""
    v_loc, off = vocab_shard_info(vocab, group)
    x = logits.float()
    g = torch.stack([gumbel(s, vocab, x.device) for s in seeds])
    if group is not None:
        g = g[:, off:off + v_loc]
    t = temperature.clamp_min(1e-6)[:, None]
    score = torch.where(temperature[:, None] > 0.0, x / t + g, x)
    return sharded_argmax(score, vocab, group)


# -- losses and metrics over the vocab row -------------------------------------

def sharded_softmax_xent(logits, labels, vocab: int, group=None):
    """Mean softmax cross-entropy over tokens, f32, with the vocab row
    sharded over ``group``: logsumexp with a stop-gradient max shift
    (the max and the sum reduced over the group), minus the target
    logit (labels outside this shard contribute a zero target, summed
    over the group)."""
    v_loc, off = vocab_shard_info(vocab, group)
    x = logits.float()
    m = x.max(dim=-1).values.detach()
    if group is not None:
        m = _all_reduce(m.contiguous(), group, dist.ReduceOp.MAX)
    s = reduce_from_group(torch.exp(x - m[..., None]).sum(dim=-1), group)
    lse = m + torch.log(s)
    local = labels - off
    hit = (local >= 0) & (local < v_loc)
    safe = local.clamp(0, v_loc - 1).long()
    tgt = torch.gather(x, -1, safe[..., None])[..., 0]
    tgt = reduce_from_group(torch.where(hit, tgt, 0.0), group)
    return (lse - tgt).mean()


def sharded_top1_err(logits, labels, vocab: int, group=None):
    """Top-1 error (the global, lowest-id argmax)."""
    pred = sharded_argmax(logits.detach().float(), vocab, group)
    return (pred != labels).float().mean()


def sharded_topk_err(logits, labels, vocab: int, k: int = 5, group=None):
    """Top-k error with the vocab row sharded: each shard's top
    min(k, V/tp) candidates, gathered over the group, then the global
    top-k among them (exact: every global top-k entry is in its own
    shard's local top-k)."""
    v_loc, off = vocab_shard_info(vocab, group)
    x = logits.detach().float()
    vals, ids = torch.topk(x, min(k, v_loc), dim=-1)
    ids = ids + off
    if group is not None:
        vals = _all_gather_last(vals, group)
        ids = _all_gather_last(ids, group)
    sel = torch.topk(vals, min(k, vals.shape[-1]), dim=-1).indices
    top = torch.gather(ids, -1, sel)
    hit = (top == labels[..., None]).any(dim=-1)
    return (1.0 - hit.float()).mean()


def _all_gather_last(t, group):
    """The group's ``t`` concatenated along the last dim, rank order."""
    out = torch.empty((group.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1),
                                group=group.device_group)
    return torch.cat(out.unbind(0), dim=-1)


# -- fused unembed + cross-entropy ------------------------------------------------

def pick_xent_chunks(v_loc: int, target: int = 4096) -> int:
    """Largest chunk count with ~``target``-wide chunks that divides
    the local vocab; 1 = chunking off (small vocab)."""
    if v_loc <= 2 * target:
        return 1
    for c in range(v_loc // target, 1, -1):
        if v_loc % c == 0:
            return c
    return 1


def _mm_f32(a, b):
    """``a @ b`` with f32 accumulation and an f32 result.  f32 operands
    multiply as they are; compute-dtype (bf16) operands keep their
    width — an upcast of both would run the product at the f32 rate —
    and take PyTorch's f32 output (``torch.mm(..., out_dtype=...)``) on
    the card.  The CPU build has no such product, so there the bf16
    result is upcast (one bf16 rounding more)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return (a @ b).float()


def _xent_grad(lg, lse, labels, g, off):
    """(softmax - onehot) * g over one [N, Vc] logits block whose
    columns are vocab ids ``[off, off + Vc)``, f32."""
    d = torch.exp(lg - lse[:, None])
    local = labels - off
    hit = (local >= 0) & (local < lg.shape[1])
    # minus one at each row's target column in this block (minus zero,
    # an exact no-op, where the target lies in another): no row count
    # read back to the host, as a boolean index would
    d.scatter_add_(1, local.clamp(0, lg.shape[1] - 1)[:, None],
                   -hit.to(d.dtype)[:, None])
    return d * g[:, None]


class ChunkedUnembedXent(torch.autograd.Function):
    """See :func:`chunked_unembed_xent`."""

    @staticmethod
    def forward(ctx, x2, w, labels, vocab, n_chunks, group):
        n = x2.shape[0]
        vc = w.shape[1] // n_chunks
        off = vocab_shard_info(vocab, group)[1]
        f32 = dict(dtype=torch.float32, device=x2.device)
        m = torch.full((n,), -torch.inf, **f32)
        s = torch.zeros((n,), **f32)
        tgt = torch.zeros((n,), **f32)
        bv = torch.full((n,), -torch.inf, **f32)
        bi = torch.full((n,), vocab, dtype=torch.int64, device=x2.device)
        for c in range(n_chunks):
            lg = (x2 @ w[:, c * vc:(c + 1) * vc].to(x2.dtype)).float()
            mc, cb = lg.max(dim=-1)
            m_new = torch.maximum(m, mc)
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = labels - (off + c * vc)
            hit = (local >= 0) & (local < vc)
            t = torch.gather(lg, 1, local.clamp(0, vc - 1)[:, None])[:, 0]
            tgt = tgt + torch.where(hit, t, 0.0)
            # running argmax: strict > keeps the EARLIEST max
            better = mc > bv
            bv = torch.where(better, mc, bv)
            bi = torch.where(better, cb + off + c * vc, bi)
        if group is not None:
            gm = _all_reduce(m.clone(), group, dist.ReduceOp.MAX)
            s = _all_reduce(s * torch.exp(m - gm), group)
            lse = gm + torch.log(torch.clamp_min(s, 1e-30))
            tgt = _all_reduce(tgt, group)
            gbv = _all_reduce(bv.clone(), group, dist.ReduceOp.MAX)
            bi = _all_reduce(torch.where(bv >= gbv, bi,
                                         torch.full_like(bi, vocab)),
                             group, dist.ReduceOp.MIN)
        else:
            lse = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(x2, w, labels, lse)
        ctx.n_chunks, ctx.off, ctx.group = n_chunks, off, group
        ctx.mark_non_differentiable(bi)
        return lse - tgt, bi

    @staticmethod
    def backward(ctx, g, _dpred):
        x2, w, labels, lse = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        vc = w.shape[1] // n_chunks
        gf = g.float()
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for c in range(n_chunks):
            wc = w[:, c * vc:(c + 1) * vc].to(x2.dtype)
            lg = (x2 @ wc).float()
            dlgc = _xent_grad(lg, lse, labels, gf,
                              ctx.off + c * vc).to(x2.dtype)
            dw[:, c * vc:(c + 1) * vc] = _mm_f32(x2.t(), dlgc)
            dx += _mm_f32(dlgc, wc.t())
        if ctx.group is not None:
            _all_reduce(dx, ctx.group)
        return dx.to(x2.dtype), dw.to(w.dtype), None, None, None, None


def chunked_unembed_xent(x2, w, labels, vocab: int, n_chunks: int,
                         group=None):
    """Fused LM head + softmax cross-entropy that never materializes the
    [N, V] logits: vocab chunks stream through an online logsumexp
    carrying (max, sumexp, target logit, argmax); the backward
    recomputes each chunk's logits.  x2 [N, D] (compute dtype), w
    [D, V/tp] (f32 master; this rank's vocab columns with ``group``,
    over which the lse, the target and the argmax combine and dx is
    summed), labels [N] global int ids.  Returns (loss_vec [N] f32 =
    lse - target, pred [N] int64)."""
    return ChunkedUnembedXent.apply(x2, w, labels.long(), vocab, n_chunks,
                                    group)


class DenseUnembedXent(torch.autograd.Function):
    """See :func:`dense_unembed_xent`."""

    @staticmethod
    def forward(ctx, x2, w, labels, vocab, group):
        v_loc, off = w.shape[1], vocab_shard_info(vocab, group)[1]
        lg = x2 @ w.to(x2.dtype)                       # [N, V] compute dtype
        lgf = lg.float()
        m, bi = lgf.max(dim=-1)
        bi = bi + off
        local = labels - off
        hit = (local >= 0) & (local < v_loc)
        tgt = torch.gather(lgf, 1, local.clamp(0, v_loc - 1)[:, None])
        tgt = torch.where(hit, tgt[:, 0], 0.0)
        if group is not None:
            gm = _all_reduce(m.clone(), group, dist.ReduceOp.MAX)
            s = _all_reduce(torch.exp(lgf - gm[:, None]).sum(dim=-1), group)
            lse = gm + torch.log(torch.clamp_min(s, 1e-30))
            tgt = _all_reduce(tgt, group)
            # gm doubles as the global best for the argmax tie-break
            bi = _all_reduce(torch.where(m >= gm, bi,
                                         torch.full_like(bi, vocab)),
                             group, dist.ReduceOp.MIN)
        else:
            s = torch.exp(lgf - m[:, None]).sum(dim=-1)
            lse = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(x2, w, labels, lg, lse)
        ctx.off, ctx.group = off, group
        ctx.mark_non_differentiable(bi)
        return lse - tgt, bi

    @staticmethod
    def backward(ctx, g, _dpred):
        x2, w, labels, lg, lse = ctx.saved_tensors
        dlgc = _xent_grad(lg.float(), lse, labels, g.float(),
                          ctx.off).to(x2.dtype)
        dw = _mm_f32(x2.t(), dlgc)
        dx = _mm_f32(dlgc, w.to(x2.dtype).t())
        if ctx.group is not None:
            _all_reduce(dx, ctx.group)
        return dx.to(x2.dtype), dw.to(w.dtype), None, None, None


def dense_unembed_xent(x2, w, labels, vocab: int, group=None):
    """Fused LM head + softmax cross-entropy with the logits
    materialized once in the compute dtype and saved for the backward
    (no recompute).  Same arguments and returns as
    :func:`chunked_unembed_xent`."""
    return DenseUnembedXent.apply(x2, w, labels.long(), vocab, group)


# -- spec-aware gradient reduction ---------------------------------------------

def grad_sync(grads: list, specs: list, layout,
              mesh_axes=("data", "model", "seq")) -> list:
    """Mean-reduce each gradient over every layout axis its parameter is
    REPLICATED on (the axes of ``mesh_axes`` absent from its spec), in
    f32, in place.  ``specs[i]`` is the JAX ``PartitionSpec`` of
    ``grads[i]`` as a tuple of entries (an axis name, a tuple of names,
    or None); ``layout`` a ``parallel.mesh.Layout``.

    ONLY for explicitly constructed per-shard gradients (a manual
    backward, or pure data-parallel forwards with no collectives) — the
    generalized BSP exchanger of the JAX package.  Do NOT apply it to
    the gradients of a model built from :func:`copy_to_group`,
    :func:`reduce_from_group` and the grouped heads: their backwards
    already deliver the exact gradient for every layout (as the
    psum/pvary transposes do under JAX's ``check_vma=True``), and a
    further reduction would double count (see models/llama.py)."""
    for g, spec in zip(grads, specs):
        used = set()
        for entry in spec:
            if entry is not None:
                used.update(entry if isinstance(entry, (tuple, list))
                            else (entry,))
        over = [a for a in mesh_axes if a not in used]
        n = 1
        for a in over:
            n *= layout.sizes[a]
        if n == 1:
            continue
        g32 = g.float()
        for a in over:
            if layout.sizes[a] > 1:
                dist.all_reduce(g32, group=layout.groups[a].device_group)
        g.copy_((g32 / n).to(g.dtype))
    return grads
