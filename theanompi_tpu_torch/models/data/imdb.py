"""IMDB sentiment input pipeline (reference:
``theanompi/models/data/imdb.py`` — tokenized IMDB reviews with
padding/truncation for the Lasagne LSTM, the GoSGD demo).

A copy of ``theanompi_tpu/models/data/imdb.py`` (numpy only): the same
seed gives both packages the same batches.

Real data: ``$TM_DATA_DIR/imdb.pkl`` in the classic Theano-tutorial
layout — two sequential pickles ``train`` then ``test``, or one pickled
``(train, test)`` tuple, each split ``(list_of_token_id_lists,
list_of_labels)``.  Absent that, a deterministic synthetic sentiment
task: each class has a token lexicon; a fraction of each review's
tokens is drawn from its class lexicon, the rest uniformly —
mean-pooled embeddings separate the classes, so LSTM convergence smoke
tests stay meaningful.

Every batch is a static ``[global_batch, maxlen]`` int32 array (pad id
0, pre-truncated): fixed shapes instead of the reference's length
bucketing.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

PAD_ID = 0
N_CLASSES = 2


def _load_real(root: Path, vocab: int):
    p = root / "imdb.pkl"
    if not p.is_file():
        return None
    with open(p, "rb") as f:
        first = pickle.load(f)
        try:
            # classic Theano-tutorial layout: train_set and test_set
            # are TWO sequential pickle objects in one file
            second = pickle.load(f)
            train, test = first, second
        except EOFError:
            # single-object layout: one pickled (train, test) tuple
            train, test = first

    def clip(split):
        xs, ys = split
        xs = [[t if t < vocab else 1 for t in seq] for seq in xs]
        return xs, np.asarray(ys, np.int32)

    return clip(train), clip(test)


def _pad(seqs, maxlen: int) -> np.ndarray:
    out = np.full((len(seqs), maxlen), PAD_ID, np.int32)
    for i, s in enumerate(seqs):
        s = s[:maxlen]
        out[i, : len(s)] = s
    return out


class ImdbData:
    """Sentiment batches: ``train_batch(i)`` → ``([GB, maxlen] int32,
    [GB] int32)``."""

    def __init__(
        self,
        batch_size: int = 32,
        n_replicas: int = 1,
        maxlen: int = 100,
        vocab: int = 10000,
        seed: int = 0,
        n_train: int | None = None,
        n_val: int | None = None,
    ):
        self.batch_size = batch_size
        self.n_replicas = n_replicas
        self.global_batch = batch_size * n_replicas
        self.maxlen = maxlen
        self.vocab = vocab
        self._seed = seed

        root = Path(os.environ.get("TM_DATA_DIR", "/data"))
        real = _load_real(root, vocab)
        self.synthetic = real is None
        if real is None:
            n_train = n_train or 2048
            n_val = n_val or 512
            tx, ty = self._make_synthetic(n_train, seed)
            vx, vy = self._make_synthetic(n_val, seed + 1)
        else:
            (tr_x, ty), (va_x, vy) = real
            if n_train:
                tr_x, ty = tr_x[:n_train], ty[:n_train]
            if n_val:
                va_x, vy = va_x[:n_val], vy[:n_val]
            tx, vx = _pad(tr_x, maxlen), _pad(va_x, maxlen)

        n_tr = len(ty) - len(ty) % self.global_batch
        n_va = len(vy) - len(vy) % self.global_batch
        self._train_x, self._train_y = tx[:n_tr], ty[:n_tr]
        self._val_x, self._val_y = vx[:n_va], vy[:n_va]
        self.n_batch_train = n_tr // self.global_batch
        self.n_batch_val = n_va // self.global_batch
        self._perm = np.arange(n_tr)

    def _make_synthetic(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        if self.vocab < 30:
            raise ValueError(
                f"synthetic IMDB needs vocab >= 30 (got {self.vocab}): "
                "ids 0/1 are pad/unk and each class needs a lexicon"
            )
        # class lexicons scale with the vocab: two disjoint id ranges
        # starting at 10 (up to 100 tokens each), e.g. [10, 110)
        # positive and [110, 210) negative at the default vocab
        lex_size = min(100, (self.vocab - 10) // 2)
        lex = [
            np.arange(10, 10 + lex_size),
            np.arange(10 + lex_size, 10 + 2 * lex_size),
        ]
        ys = rng.integers(0, N_CLASSES, n).astype(np.int32)
        xs = np.full((n, self.maxlen), PAD_ID, np.int32)
        lengths = rng.integers(self.maxlen // 4, self.maxlen + 1, n)
        for i in range(n):
            ln = lengths[i]
            toks = rng.integers(2, self.vocab, ln)
            from_lex = rng.random(ln) < 0.2
            toks[from_lex] = rng.choice(lex[ys[i]], from_lex.sum())
            xs[i, :ln] = toks
        return xs, ys

    def shuffle(self, epoch: int) -> None:
        rng = np.random.default_rng(self._seed + epoch)
        self._perm = rng.permutation(len(self._train_y))

    def dataset_arrays(self, split: str = "train"):
        """Full (x, y) arrays for HBM-resident caching
        (``device_data_cache`` model knob) — the whole padded token
        set is [n, maxlen] int32, trivially HBM-sized."""
        if split not in ("train", "val"):
            raise ValueError(
                f"unknown split {split!r} (expected 'train' or 'val')"
            )
        if split == "train":
            return self._train_x, self._train_y
        return self._val_x, self._val_y

    def epoch_permutation(self):
        return self._perm

    def train_batch(self, i: int):
        sel = self._perm[i * self.global_batch : (i + 1) * self.global_batch]
        return self._train_x[sel], self._train_y[sel]

    def val_batch(self, i: int):
        sl = slice(i * self.global_batch, (i + 1) * self.global_batch)
        return self._val_x[sl], self._val_y[sl]
