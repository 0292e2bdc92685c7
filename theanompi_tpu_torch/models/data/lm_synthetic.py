"""Synthetic language-modeling data: order-1 Markov token streams.

A copy of ``theanompi_tpu/models/data/lm_synthetic.py`` (numpy only):
the same seed gives both packages the same batches.

New-framework scope (the reference has no LM workload; this feeds the
Llama-class models in the zero-egress image).  A fixed random
transition matrix with low entropy gives next-token structure a
transformer learns within a few hundred steps, so convergence smoke
tests are meaningful; real corpora drop in behind the same batch API.

Batches are ``(inputs [GB, T], targets [GB, T])`` — targets are inputs
shifted by one, both int32 with STATIC shapes (T fixed) so the jitted
step never retraces.
"""

from __future__ import annotations

import numpy as np


class MarkovLMData:
    def __init__(
        self,
        vocab: int = 256,
        seq_len: int = 256,
        batch_size: int = 8,
        n_replicas: int = 1,
        n_train: int = 2048,
        n_val: int = 256,
        branching: int = 4,
        seed: int = 0,
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.global_batch = batch_size * n_replicas
        rng = np.random.default_rng(seed)
        # each token transitions to one of `branching` successors,
        # with a mildly peaked distribution
        succ = rng.integers(0, vocab, (vocab, branching))
        probs = rng.dirichlet(np.full(branching, 0.5), size=vocab)
        self._succ, self._probs = succ, probs
        self._cum = np.cumsum(probs, axis=1)
        self._seed = seed

        n_train -= n_train % self.global_batch
        n_val -= n_val % self.global_batch
        self.n_batch_train = n_train // self.global_batch
        self.n_batch_val = n_val // self.global_batch
        self._train = self._gen(n_train, seed + 1)
        self._val = self._gen(n_val, seed + 2)
        self._perm = np.arange(n_train)

    def _gen(self, n: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((n, self.seq_len + 1), np.int32)
        tok = rng.integers(0, self.vocab, n)
        out[:, 0] = tok
        for t in range(1, self.seq_len + 1):
            # vectorized categorical draw per row
            r = rng.random(n)
            choice = (r[:, None] < self._cum[tok]).argmax(axis=1)
            tok = self._succ[tok, choice]
            out[:, t] = tok
        return out

    def shuffle(self, epoch: int) -> None:
        rng = np.random.default_rng(self._seed + epoch)
        self._perm = rng.permutation(len(self._train))

    # -- device-cache accessors (Llama's HBM-resident step) ---------------

    def dataset_sequences(self) -> np.ndarray:
        """The whole train set [N, T+1] for one-time HBM staging."""
        return self._train

    def epoch_permutation(self) -> np.ndarray:
        return self._perm

    def batch_indices(self, i: int) -> np.ndarray:
        """Sample ids of window ``i`` — the streaming loader's
        journal key (the elastic drills' zero-lost/dup accounting)."""
        return self._perm[
            i * self.global_batch : (i + 1) * self.global_batch
        ]

    def train_batch(self, i: int):
        sel = self.batch_indices(i)
        seq = self._train[sel]
        return seq[:, :-1], seq[:, 1:]

    def val_batch(self, i: int):
        seq = self._val[i * self.global_batch : (i + 1) * self.global_batch]
        return seq[:, :-1], seq[:, 1:]
