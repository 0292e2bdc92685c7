"""Tensor-parallel building blocks at tp=1.

Port of the serving subset of ``theanompi_tpu/parallel/tp.py``.  With
one shard the model-axis collectives are identities, so the column-
and row-parallel products are plain ``x @ w`` and the vocab-sharded
samplers act on the full vocab row.  The argmax keeps the JAX
package's tie-break (lowest id: ``torch.argmax`` returns the first
maximum).

Sampling draws Gumbel noise for the full vocab from a
``torch.Generator`` seeded per row by the caller (request seed folded
with the token position, see :func:`fold_seed`), so a row's draw
depends only on its own seed and position: batched equals single.
These are not ``jax.random``'s bits and are not meant to be.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def col_parallel(x, w):
    """[..., D] x [D, F] -> [..., F]."""
    return x @ w.to(x.dtype)


def row_parallel(x, w):
    """[..., F] x [F, D] -> [..., D] (the psum of one shard)."""
    return x @ w.to(x.dtype)


def embed_lookup(ids, table, vocab: int):
    """Embedding rows for ``ids``; ids outside [0, vocab) give zero
    vectors, as the sharded lookup's misses do."""
    hit = (ids >= 0) & (ids < vocab)
    safe = ids.clamp(0, vocab - 1).long()
    return table[safe] * hit[..., None].to(table.dtype)


def sharded_argmax(score, vocab: int):
    """Argmax over the vocab row [..., V]; ties break to the lowest id."""
    del vocab
    return torch.argmax(score, dim=-1)


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


def sharded_sample(logits, vocab: int, seeds, temperature):
    """One token id per row from logits [N, V].  ``seeds``: N host
    ints, one per row, already folded with the row's position;
    ``temperature`` [N] f32.  Rows at temperature <= 0 decode greedily;
    the rest take ``argmax(logits / T + g)`` with Gumbel noise g, an
    exact draw from ``softmax(logits / T)``."""
    x = logits.float()
    g = torch.stack([gumbel(s, vocab, x.device) for s in seeds])
    t = temperature.clamp_min(1e-6)[:, None]
    score = torch.where(temperature[:, None] > 0.0, x / t + g, x)
    return sharded_argmax(score, vocab)
