"""Tensor-parallel building blocks.

Port of ``theanompi_tpu/parallel/tp.py``.  The JAX functions run inside
``shard_map`` and reduce over the ``model`` mesh axis; here each rank
is a process and the model axis is a :class:`~theanompi_tpu_torch.
parallel.mesh.ModelGroup` passed as ``group``.  With ``group=None``
(tp = 1) the collectives are identities and every function is the
plain one-shard expression: the column- and row-parallel products are
``x @ w`` and the samplers act on the full vocab row.  With a group
(serving at tp > 1; training keeps tp = 1):

- :func:`row_parallel` sums the ranks' partial products in the compute
  dtype (``lax.psum(x @ w.astype(x.dtype))``);
- :func:`embed_lookup` reads the rank's rows of the vocab-sharded table
  (misses give zeros) and sums them;
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
products, which accumulate and return in f32 (``_mm_f32``).

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
    y = x @ w.to(x.dtype)
    return y if group is None else _all_reduce(y, group)


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
    return vecs if group is None else _all_reduce(vecs, group)


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

def sharded_softmax_xent(logits, labels, vocab: int):
    """Mean softmax cross-entropy over tokens, f32: logsumexp with a
    stop-gradient max shift, minus the target logit (labels outside
    [0, vocab) contribute a zero target, as a sharded miss does)."""
    x = logits.float()
    m = x.max(dim=-1).values.detach()
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
    hit = (labels >= 0) & (labels < vocab)
    safe = labels.clamp(0, vocab - 1).long()
    tgt = torch.gather(x, -1, safe[..., None])[..., 0]
    tgt = torch.where(hit, tgt, 0.0)
    return (lse - tgt).mean()


def sharded_top1_err(logits, labels, vocab: int):
    """Top-1 error (lowest-id argmax)."""
    pred = sharded_argmax(logits.detach().float(), vocab)
    return (pred != labels).float().mean()


def sharded_topk_err(logits, labels, vocab: int, k: int = 5):
    """Top-k error."""
    x = logits.detach().float()
    top = torch.topk(x, min(k, x.shape[-1]), dim=-1).indices
    hit = (top == labels[..., None]).any(dim=-1)
    return (1.0 - hit.float()).mean()


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
    rows = torch.nonzero((local >= 0) & (local < lg.shape[1]))[:, 0]
    d[rows, local[rows]] -= 1.0
    return d * g[:, None]


class ChunkedUnembedXent(torch.autograd.Function):
    """See :func:`chunked_unembed_xent`."""

    @staticmethod
    def forward(ctx, x2, w, labels, vocab, n_chunks):
        n = x2.shape[0]
        vc = w.shape[1] // n_chunks
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
            local = labels - c * vc
            hit = (local >= 0) & (local < vc)
            t = torch.gather(lg, 1, local.clamp(0, vc - 1)[:, None])[:, 0]
            tgt = tgt + torch.where(hit, t, 0.0)
            # running argmax: strict > keeps the EARLIEST max
            better = mc > bv
            bv = torch.where(better, mc, bv)
            bi = torch.where(better, cb + c * vc, bi)
        lse = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(x2, w, labels, lse)
        ctx.n_chunks = n_chunks
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
            dlgc = _xent_grad(lg, lse, labels, gf, c * vc).to(x2.dtype)
            dw[:, c * vc:(c + 1) * vc] = _mm_f32(x2.t(), dlgc)
            dx += _mm_f32(dlgc, wc.t())
        return dx.to(x2.dtype), dw.to(w.dtype), None, None, None


def chunked_unembed_xent(x2, w, labels, vocab: int, n_chunks: int):
    """Fused LM head + softmax cross-entropy that never materializes the
    [N, V] logits: vocab chunks stream through an online logsumexp
    carrying (max, sumexp, target logit, argmax); the backward
    recomputes each chunk's logits.  x2 [N, D] (compute dtype), w
    [D, V] (f32 master), labels [N] int.  Returns (loss_vec [N] f32 =
    lse - target, pred [N] int64)."""
    return ChunkedUnembedXent.apply(x2, w, labels.long(), vocab, n_chunks)


class DenseUnembedXent(torch.autograd.Function):
    """See :func:`dense_unembed_xent`."""

    @staticmethod
    def forward(ctx, x2, w, labels, vocab):
        lg = x2 @ w.to(x2.dtype)                       # [N, V] compute dtype
        lgf = lg.float()
        m, bi = lgf.max(dim=-1)
        hit = (labels >= 0) & (labels < w.shape[1])
        tgt = torch.gather(lgf, 1, labels.clamp(0, w.shape[1] - 1)[:, None])
        tgt = torch.where(hit, tgt[:, 0], 0.0)
        s = torch.exp(lgf - m[:, None]).sum(dim=-1)
        lse = m + torch.log(torch.clamp_min(s, 1e-30))
        ctx.save_for_backward(x2, w, labels, lg, lse)
        ctx.mark_non_differentiable(bi)
        return lse - tgt, bi

    @staticmethod
    def backward(ctx, g, _dpred):
        x2, w, labels, lg, lse = ctx.saved_tensors
        dlgc = _xent_grad(lg.float(), lse, labels, g.float(), 0).to(x2.dtype)
        dw = _mm_f32(x2.t(), dlgc)
        dx = _mm_f32(dlgc, w.to(x2.dtype).t())
        return dx.to(x2.dtype), dw.to(w.dtype), None, None


def dense_unembed_xent(x2, w, labels, vocab: int):
    """Fused LM head + softmax cross-entropy with the logits
    materialized once in the compute dtype and saved for the backward
    (no recompute).  Same arguments and returns as
    :func:`chunked_unembed_xent`."""
    return DenseUnembedXent.apply(x2, w, labels.long(), vocab)
