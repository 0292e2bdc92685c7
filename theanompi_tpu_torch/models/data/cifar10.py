"""CIFAR-10 input pipeline (reference: ``theanompi/models/data/cifar10.py``
— load python pickle batches, standardize; feeds Wide-ResNet).

A copy of ``theanompi_tpu/models/data/cifar10.py`` (numpy only) with
its imports pointed at the port: the same seed gives both packages the
same batches.

Loads the standard ``cifar-10-batches-py`` pickle files from
``$TM_DATA_DIR/cifar-10-batches-py`` when present; otherwise falls back
to a deterministic synthetic CIFAR-shaped dataset (zero-egress image).
Standardization is global mean/std like the reference; augmentation
(random crop with 4px pad + horizontal flip, the WRN recipe) is
host-side numpy, applied per batch.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

from theanompi_tpu_torch.models.data.synthetic import SyntheticClassData

SHAPE = (32, 32, 3)
N_CLASSES = 10


def _load_real(root: Path):
    d = root / "cifar-10-batches-py"
    if not d.is_dir():
        return None
    xs, ys = [], []
    for i in range(1, 6):
        with open(d / f"data_batch_{i}", "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xs.append(b[b"data"])
        ys.append(b[b"labels"])
    with open(d / "test_batch", "rb") as f:
        t = pickle.load(f, encoding="bytes")
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    train_y = np.concatenate(ys).astype(np.int32)
    val_x = np.asarray(t[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    val_y = np.asarray(t[b"labels"], np.int32)
    return (
        train_x.astype(np.float32),
        train_y,
        val_x.astype(np.float32),
        val_y,
    )


class Cifar10Data:
    def __init__(
        self,
        batch_size: int = 128,
        n_replicas: int = 1,
        augment: bool = True,
        seed: int = 0,
        n_train: int | None = None,
        n_val: int | None = None,
        label_noise: float = 0.0,
    ):
        self.batch_size = batch_size
        self.n_replicas = n_replicas
        self.global_batch = batch_size * n_replicas
        self.augment = augment
        self._seed = seed

        root = Path(os.environ.get("TM_DATA_DIR", "/data"))
        real = _load_real(root)
        self.synthetic = real is None
        if real is None:
            self._syn = SyntheticClassData(
                SHAPE,
                N_CLASSES,
                batch_size,
                n_replicas,
                n_train=n_train or 2048,
                n_val=n_val or 512,
                label_noise=label_noise,
                seed=seed,
            )
            self.n_batch_train = self._syn.n_batch_train
            self.n_batch_val = self._syn.n_batch_val
            return

        train_x, train_y, val_x, val_y = real
        if n_train:  # honor subset requests (smoke configs) on real data
            train_x, train_y = train_x[:n_train], train_y[:n_train]
        if n_val:
            val_x, val_y = val_x[:n_val], val_y[:n_val]
        if label_noise > 0.0:
            # same semantics as the synthetic path (shared helper): a
            # fraction of RETURNED labels resampled uniformly, images
            # untouched — the convergence drills need the noise floor
            # on either path
            from theanompi_tpu_torch.models.data.synthetic import (
                resample_labels,
            )

            train_y = resample_labels(
                train_y, label_noise, N_CLASSES, seed, 3
            )
            val_y = resample_labels(val_y, label_noise, N_CLASSES, seed, 4)
        mean = train_x.mean(axis=(0, 1, 2), keepdims=True)
        std = train_x.std(axis=(0, 1, 2), keepdims=True)
        self._train_x = (train_x - mean) / std
        self._train_y = train_y
        self._val_x = (val_x - mean) / std
        self._val_y = val_y
        n_tr = len(train_y) - len(train_y) % self.global_batch
        n_va = len(val_y) - len(val_y) % self.global_batch
        self.n_batch_train = n_tr // self.global_batch
        self.n_batch_val = n_va // self.global_batch
        self._perm = np.arange(len(train_y))

    def shuffle(self, epoch: int) -> None:
        if self.synthetic:
            self._syn.shuffle(epoch)
        else:
            rng = np.random.default_rng(self._seed + epoch)
            self._perm = rng.permutation(len(self._train_y))
        self._epoch = epoch

    def _augment(self, x: np.ndarray, epoch: int, seq: int) -> np.ndarray:
        """Pad-4-reflect, random 32x32 crop + horizontal flip, with
        draws from ``aug_rng.crop_flip_draws`` so they are a pure
        function of (seed, epoch, seq, image) — identical no matter
        which producer serves the batch (ADVICE r2: this path kept a
        per-call np RNG after imagenet.py moved to aug_rng)."""
        from theanompi_tpu_torch.models.data.aug_rng import crop_flip_draws

        n, h, w, _ = x.shape
        padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
        ii, jj, flip = crop_flip_draws(
            self._seed, epoch, seq, n, h + 8, w + 8, h
        )
        out = np.empty_like(x)
        for k in range(n):
            img = padded[k, ii[k] : ii[k] + h, jj[k] : jj[k] + w]
            out[k] = img[:, ::-1] if flip[k] else img
        return out

    def train_batch(self, i: int):
        if self.synthetic:
            return self._syn.train_batch(i)
        sel = self._perm[i * self.global_batch : (i + 1) * self.global_batch]
        x, y = self._train_x[sel], self._train_y[sel]
        if self.augment:
            x = self._augment(x, getattr(self, "_epoch", 0), i)
        return x, y

    def val_batch(self, i: int):
        if self.synthetic:
            return self._syn.val_batch(i)
        sl = slice(i * self.global_batch, (i + 1) * self.global_batch)
        return self._val_x[sl], self._val_y[sl]

    def batch_indices(self, i: int):
        """Device-resident dataset support (``device_data_cache``);
        note the real-data path then skips host-side augmentation —
        the cached dataset is the standardized images."""
        if self.synthetic:
            return self._syn.batch_indices(i)
        return self._perm[i * self.global_batch : (i + 1) * self.global_batch]

    def epoch_permutation(self):
        if self.synthetic:
            return self._syn.epoch_permutation()
        return self._perm

    def dataset_arrays(self, split: str = "train"):
        if self.synthetic:
            return self._syn.dataset_arrays(split)
        if split == "train":
            return self._train_x, self._train_y
        return self._val_x, self._val_y
