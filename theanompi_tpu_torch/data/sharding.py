"""Elastic shard cursors: which samples belong to worker w of n.

A copy of ``theanompi_tpu/data/sharding.py`` (numpy only).

The reference gave each MPI rank its own file list; our SPMD workers
all see the same in-memory dataset, so sharding is an INDEXING rule:
worker ``w`` of ``n`` reads every n-th sample of each epoch-permutation
batch window (``sel[w::n]``).  The rule's invariant is what makes it
elastic — for any world size ``n``, the union of the per-worker strides
over a window is exactly that window, so a run killed at world 8 and
resumed at world 4 re-partitions the SAME remaining sample ids with
zero lost and zero duplicated (the elastic drill's journal proof), and
the ``"global"`` batch policy keeps the union — hence the gradient —
identical across world sizes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ShardedBatches", "shard_ids", "coverage_check"]


def shard_ids(ids, w: int, n: int):
    """Sample ids of worker ``w`` of ``n`` for one batch window: the
    stride rule ``ids[w::n]``.  Partition invariant: the union over
    ``w`` is ``ids`` for every ``n`` — the elastic property."""
    if not 0 <= w < n:
        raise ValueError(f"worker {w} out of range for world {n}")
    return np.asarray(ids)[w::n]


class ShardedBatches:
    """Worker-``w``-of-``n`` view over a model-data object.

    Presents the same ``train_batch(i)`` / ``batch_indices(i)`` /
    ``shuffle(epoch)`` surface as the underlying data, restricted to
    this worker's stride of each batch window — a drop-in ``fetch``
    for :class:`~theanompi_tpu_torch.data.pipeline.StreamingLoader`.  Epoch
    length and the permutation are the GLOBAL ones (all workers agree
    on ``n_batch_train`` and the shuffle), only the per-batch slice
    differs.
    """

    def __init__(self, data, worker: int, world: int):
        if not 0 <= worker < world:
            raise ValueError(
                f"worker {worker} out of range for world {world}"
            )
        self.data = data
        self.worker = int(worker)
        self.world = int(world)

    @property
    def n_batch_train(self) -> int:
        return self.data.n_batch_train

    @property
    def global_batch(self) -> int:
        return self.data.global_batch

    def shuffle(self, epoch: int) -> None:
        self.data.shuffle(epoch)

    def batch_indices(self, i: int):
        return shard_ids(
            self.data.batch_indices(i), self.worker, self.world
        )

    def train_batch(self, i: int):
        sel = self.batch_indices(i)
        return self.data._train_x[sel], self.data._train_y[sel]


def coverage_check(entries, *, global_batch, n_batch_train,
                   perm_for_epoch):
    """Zero-lost / zero-duplicated proof over a loader journal.

    ``entries`` — journal dicts with ``epoch``, ``iter``, ``world``,
    ``worker``, ``ids`` (as written by ``StreamingLoader`` with a
    ``journal_meta``).  For every (epoch, iter) window touched, the
    union of the recorded per-worker id sets must equal the stride
    partition of ``perm_for_epoch(epoch)``'s window — ANY world size
    per window (that is the reshard).  Returns ``(lost, dup)`` id
    lists; both empty on a clean stream.
    """
    by_window: dict = {}
    dup: list = []
    for e in entries:
        key = (e["epoch"], e["iter"])
        seen = by_window.setdefault(key, set())
        for s in e["ids"]:
            if s in seen:
                dup.append(s)
            seen.add(s)
    lost: list = []
    for (epoch, i), seen in sorted(by_window.items()):
        perm = np.asarray(perm_for_epoch(epoch))
        want = set(
            int(s)
            for s in perm[i * global_batch:(i + 1) * global_batch]
        )
        lost.extend(sorted(want - seen))
        dup.extend(sorted(seen - want))
    return lost, dup
