"""Deterministic class-separable synthetic data.

A copy of ``theanompi_tpu/models/data/synthetic.py`` (numpy only): the
same seed gives both packages the same batches.

Stand-in when real datasets are absent (zero-egress environment).
Each class c gets a fixed random template image; samples are
template[c] + N(0, noise).  A linear probe reaches high accuracy in a
few steps, so convergence smoke tests (SURVEY §4d) stay meaningful
without shipping datasets.
"""

from __future__ import annotations

import numpy as np


def resample_labels(
    arr: np.ndarray, frac: float, n_classes: int, seed: int, salt: int
) -> np.ndarray:
    """Uniformly resample ``frac`` of the labels (label-noise floor
    for the convergence drills).  Shared by the synthetic and
    real-CIFAR paths so 'same semantics on either path' stays true by
    construction."""
    arr = arr.copy()
    nrng = np.random.default_rng(seed + 7919 * salt)
    flip = nrng.random(len(arr)) < frac
    arr[flip] = nrng.integers(
        0, n_classes, int(flip.sum())
    ).astype(np.int32)
    return arr


class SyntheticClassData:
    def __init__(
        self,
        input_shape: tuple,
        n_classes: int,
        batch_size: int,
        n_replicas: int = 1,
        n_train: int = 2048,
        n_val: int = 512,
        noise: float = 0.5,
        label_noise: float = 0.0,
        seed: int = 0,
        dtype=np.float32,
    ):
        self.input_shape = tuple(input_shape)
        self.n_classes = n_classes
        self.batch_size = batch_size          # per replica
        self.n_replicas = n_replicas
        self.global_batch = batch_size * n_replicas
        self.n_train = n_train - n_train % self.global_batch
        self.n_val = n_val - n_val % self.global_batch
        self.n_batch_train = self.n_train // self.global_batch
        self.n_batch_val = self.n_val // self.global_batch
        self.noise = noise
        self.dtype = dtype

        rng = np.random.default_rng(seed)
        # Coarse class templates (<=16px per spatial dim), upsampled on
        # demand — a full-res (1000, 224, 224, 3) float32 table would
        # cost ~600 MB per ImageNet-shaped instance for no test value.
        self._coarse_shape = tuple(
            min(16, d) if i < max(len(self.input_shape) - 1, 1) else d
            for i, d in enumerate(self.input_shape)
        )
        self._coarse = rng.normal(
            size=(n_classes, *self._coarse_shape)
        ).astype(dtype)
        self._upsample_idx = [
            (np.arange(full) * coarse // full)
            for full, coarse in zip(self.input_shape, self._coarse_shape)
        ]
        self._train_y = rng.integers(0, n_classes, self.n_train).astype(np.int32)
        self._val_y = rng.integers(0, n_classes, self.n_val).astype(np.int32)
        # label_noise: resample that fraction of RETURNED labels
        # uniformly while the image keeps its ORIGINAL class's
        # template (the clean copies below feed image generation —
        # flipping before generation would re-template the image to
        # the new class and produce a self-consistent, noise-free
        # task).  Puts a floor of ~label_noise*(C-1)/C on val error,
        # so convergence drills plateau OFF zero and 1-vs-N curve
        # comparisons stay discriminative at the plateau (two curves
        # stuck at 0.0 agree trivially).
        self._train_y_clean = self._train_y
        self._val_y_clean = self._val_y
        self.label_noise = float(label_noise)
        if self.label_noise > 0.0:
            self._train_y = resample_labels(
                self._train_y, self.label_noise, n_classes, seed, 3
            )
            self._val_y = resample_labels(
                self._val_y, self.label_noise, n_classes, seed, 4
            )
        self._train_seed = seed + 1
        self._val_seed = seed + 2
        self._perm = np.arange(self.n_train)

    def shuffle(self, epoch: int) -> None:
        rng = np.random.default_rng(self._train_seed + epoch)
        self._perm = rng.permutation(self.n_train)

    def _template(self, ys: np.ndarray) -> np.ndarray:
        t = self._coarse[ys]
        for axis, idx in enumerate(self._upsample_idx):
            if len(idx) != t.shape[axis + 1]:
                t = np.take(t, idx, axis=axis + 1)
        return t

    def _make(self, ys: np.ndarray, seed: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        if np.dtype(self.dtype) == np.float32:
            # draw directly in fp32 — ~2x faster, no temp fp64 array
            noise = rng.standard_normal(
                (len(ys), *self.input_shape), np.float32
            )
        else:
            noise = rng.standard_normal(
                (len(ys), *self.input_shape)
            ).astype(self.dtype)
        x = self._template(ys) + self.noise * noise
        return x.astype(self.dtype), ys

    def _materialize_train(self) -> None:
        """Generate the train set ONCE (lazily) so ``train_batch`` is a
        slice, like reading pre-batched files — per-call generation of
        e.g. 128 fresh 224² gaussians costs seconds of host time per
        batch and would serialize the device (it dominated the first
        contract-path bench).  Noise becomes fixed per example, which
        matches real-dataset semantics."""
        if getattr(self, "_train_x", None) is not None:
            return
        chunks = []
        step = max(1, (1 << 24) // int(np.prod(self.input_shape)))
        for s in range(0, self.n_train, step):
            ys = self._train_y_clean[s : s + step]  # template = clean class
            chunks.append(self._make(ys, self._train_seed * 100003 + s)[0])
        self._train_x = np.concatenate(chunks) if chunks else np.empty(
            (0, *self.input_shape), self.dtype
        )

    def train_batch(self, i: int):
        self._materialize_train()
        sel = self.batch_indices(i)
        return self._train_x[sel], self._train_y[sel]

    def epoch_permutation(self) -> np.ndarray:
        """Current epoch's full example permutation (device-resident
        schedule: staged to HBM once per epoch; batch i is the i-th
        global_batch-sized slice)."""
        self._materialize_train()
        return self._perm

    def batch_indices(self, i: int) -> np.ndarray:
        """Example indices of train batch ``i`` under the current epoch
        permutation (device-resident dataset support: the model gathers
        these on device instead of staging the batch over PCIe/DCN)."""
        return self._perm[i * self.global_batch : (i + 1) * self.global_batch]

    def dataset_arrays(self, split: str = "train"):
        """Full (x, y) arrays for HBM-resident caching
        (``device_data_cache`` model knob)."""
        if split == "train":
            self._materialize_train()
            return self._train_x, self._train_y
        xs, ys = zip(*[
            self.val_batch(i) for i in range(self.n_batch_val)
        ]) if self.n_batch_val else ((), ())
        return (
            np.concatenate(xs) if xs else
            np.empty((0, *self.input_shape), self.dtype),
            np.concatenate(ys) if ys else np.empty((0,), np.int32),
        )

    def val_batch(self, i: int):
        sl = slice(i * self.global_batch, (i + 1) * self.global_batch)
        x, _ = self._make(self._val_y_clean[sl], self._val_seed * 100003 + i)
        return x, self._val_y[sl]
