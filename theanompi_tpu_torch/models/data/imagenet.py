"""ImageNet input pipeline with asynchronous prefetch.

Reference: ``theanompi/models/data/imagenet.py`` — pre-batched hickle
(HDF5) files of 128-image tensors + stored image mean, shuffled file
lists per epoch — and ``proc_load_mpi.py``: one spawned loader process
per worker (``MPI.COMM_SELF.Spawn``) doing load → random crop +
horizontal flip − mean → deliver into a shared GPU buffer, overlapping
I/O/augmentation with compute (pipeline depth 1).

A copy of ``theanompi_tpu/models/data/imagenet.py`` (numpy only) with
its imports pointed at the port: pre-batched shard files (one file per
global batch: ``x`` uint8 [B, H, W, 3], ``y`` int32 [B]) under
``$TM_DATA_DIR/imagenet_batches/{train,val}/`` in either format —
``.tmb`` (raw, mmap-friendly; ``theanompi_tpu_torch.native``) or
``.npz`` — with a shuffled file list per epoch, read ahead by the C++
loader over ``.tmb`` files (``native.NativeBatchLoader``, built with the
system ``g++`` at first use) or, without a toolchain or for ``.npz``, by
a background Python prefetch thread.  Both draw their crops from
``aug_rng``, so the batches are bitwise the same either way.
``feed`` names the producer that serves the epoch: ``"native"``,
``"thread"`` or ``"synthetic"``.

The augmentation (random 224 crop from 256 + hflip − mean) matches the
reference's loader.  Synthetic fallback when no files exist.
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path

import numpy as np

from theanompi_tpu_torch.models.data.synthetic import SyntheticClassData

RAW_SHAPE = (256, 256, 3)       # stored batch images (reference: 256x256)
CROP = 224                       # training crop
N_CLASSES = 1000


class _PrefetchThread(threading.Thread):
    """Reads/augments batches ahead of the consumer (proc_load_mpi
    equivalent; a thread suffices because numpy augmentation releases
    the GIL for the heavy ops and the consumer is device-bound)."""

    def __init__(self, make_batch, n_batches: int, depth: int = 2):
        super().__init__(daemon=True)
        self.make_batch = make_batch
        self.n_batches = n_batches
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

    def run(self):
        for i in range(self.n_batches):
            if self._stop.is_set():
                return
            try:
                item = self.make_batch(i)
            except BaseException as e:  # propagate to the consumer —
                # a dead producer must not leave train_batch blocked
                # on an empty queue forever
                self.q.put(e)
                return
            self.q.put(item)

    def get(self):
        item = self.q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def stop(self):
        self._stop.set()
        try:  # unblock a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


class ImageNetData:
    """Data object for the ImageNet model zoo (AlexNet/VGG/GoogLeNet/
    ResNet-50).  Protocol: n_batch_train/n_batch_val/train_batch/
    val_batch/shuffle, plus ``start_prefetch(epoch)`` for the async
    pipeline (workers call it automatically when present)."""

    def __init__(
        self,
        batch_size: int = 128,
        n_replicas: int = 1,
        crop: int = CROP,
        prefetch_depth: int = 2,
        seed: int = 0,
        n_train: int | None = None,
        n_val: int | None = None,
        u8_wire: bool = True,
    ):
        self.batch_size = batch_size
        self.n_replicas = n_replicas
        self.global_batch = batch_size * n_replicas
        self.crop = crop
        self.prefetch_depth = prefetch_depth
        self._seed = seed
        self._u8 = bool(u8_wire)
        # device_mean: set (u8 wire, real files) => batches cross the
        # host->device link as uint8 crops and the MODEL subtracts the
        # mean on device (ClassifierModel.prep_input) — 4x fewer bytes
        # through the host and the link, exact same numbers (u8->f32
        # is exact).  None => fp32 batches arrive mean-subtracted.
        self.device_mean = None
        self._epoch = 0
        self._prefetch: _PrefetchThread | None = None
        self._prefetch_pos = -1  # no prefetch in flight until shuffle()
        self._native = None  # None=untried, False=unavailable, else loader
        self.feed = None     # the epoch's producer, set by start_prefetch

        root = Path(os.environ.get("TM_DATA_DIR", "/data"))
        bdir = root / "imagenet_batches"

        def find(split: str) -> list[Path]:
            if not bdir.is_dir():
                return []
            tmb = sorted((bdir / split).glob("*.tmb"))
            return tmb or sorted((bdir / split).glob("*.npz"))

        self._train_files: list[Path] = find("train")
        self._val_files: list[Path] = find("val")
        self.synthetic = not self._train_files

        if self.synthetic:
            self.feed = "synthetic"
            shape = (crop, crop, 3)
            self._syn = SyntheticClassData(
                shape,
                N_CLASSES,
                batch_size,
                n_replicas,
                n_train=n_train or 16 * self.global_batch,
                n_val=n_val or 4 * self.global_batch,
                seed=seed,
            )
            self.n_batch_train = self._syn.n_batch_train
            self.n_batch_val = self._syn.n_batch_val
            self.img_mean = np.zeros((1, crop, crop, 3), np.float32)
            return

        mean_file = bdir / "img_mean.npy"
        self.img_mean = (
            np.load(mean_file).astype(np.float32)
            if mean_file.exists()
            else np.full((1, 1, 1, 3), 128.0, np.float32)
        )
        if self._u8:
            self.device_mean = self._center_mean()
        self._file_perm = np.arange(len(self._train_files))
        self.n_batch_train = len(self._train_files)
        self.n_batch_val = len(self._val_files)

    # -- epoch-level shuffle of the batch-file list (reference behavior) --

    def shuffle(self, epoch: int) -> None:
        self._epoch = epoch
        if self.synthetic:
            self._syn.shuffle(epoch)
        else:
            rng = np.random.default_rng(self._seed + epoch)
            self._file_perm = rng.permutation(len(self._train_files))
        self.start_prefetch(epoch)

    # -- augmentation (reference: proc_load_mpi crop/flip/mean-sub) -------

    def _augment(self, x: np.ndarray, epoch: int, seq: int) -> np.ndarray:
        """Crop+flip-mean with draws that are a pure function of
        (seed, epoch, seq, image) — identical whichever producer runs
        (``aug_rng`` twins the C++ loader's splitmix64 derivation)."""
        from theanompi_tpu_torch.models.data.aug_rng import crop_flip_draws

        n, h, w, _ = x.shape
        c = self.crop
        ii, jj, flip = crop_flip_draws(
            self._seed, epoch, seq, n, h, w, c
        )
        if self._u8:
            self._require_u8(x)
        out = np.empty((n, c, c, 3), np.uint8 if self._u8 else np.float32)
        for k in range(n):
            img = x[k, ii[k] : ii[k] + c, jj[k] : jj[k] + c]
            out[k] = img[:, ::-1] if flip[k] else img
        if self._u8:
            return out          # mean-subtract happens on device
        return out - self._center_mean()

    @staticmethod
    def _require_u8(x: np.ndarray) -> None:
        """The u8 wire copies into a uint8 buffer — a float source
        (e.g. a .npz written with pre-normalized pixels) would be
        silently truncated/wrapped by numpy's unsafe cast.  Refuse
        loudly; such datasets must use u8_wire=False."""
        if np.asarray(x).dtype != np.uint8:
            raise ValueError(
                f"u8_wire needs uint8 batch files; got {x.dtype} — "
                f"pass ImageNetData(u8_wire=False) for float sources "
                f"(host-side mean-subtract wire)"
            )

    def _center_mean(self) -> np.ndarray:
        m = self.img_mean
        if m.shape[1] >= self.crop:
            off = (m.shape[1] - self.crop) // 2
            return m[:, off : off + self.crop, off : off + self.crop]
        return m

    def _check_batch(self, x: np.ndarray, f: Path) -> None:
        if x.shape[0] != self.global_batch:
            raise ValueError(
                f"pre-batched file {f} holds {x.shape[0]} images but the "
                f"configured global batch is {self.global_batch} "
                f"({self.batch_size}/replica x {self.n_replicas}); "
                f"re-shard the files (write_batch_files) or fix batch_size"
            )

    @staticmethod
    def _read_file(f: Path) -> tuple[np.ndarray, np.ndarray]:
        if f.suffix == ".tmb":
            from theanompi_tpu_torch.native import read_tmb

            return read_tmb(f)
        with np.load(f) as z:
            return z["x"], z["y"].astype(np.int32)

    def _load_train(self, i: int):
        f = self._train_files[self._file_perm[i % len(self._file_perm)]]
        x, y = self._read_file(f)
        x = np.asarray(x) if self._u8 else np.asarray(x, np.float32)
        self._check_batch(x, f)
        x = self._augment(x, self._epoch, i)
        return x, np.asarray(y, np.int32)

    # -- async prefetch (proc_load_mpi equivalent) ------------------------

    def _native_loader(self):
        """Build (once) the C++ loader over .tmb files, or None."""
        if self._native is False:
            return None
        if self._native is None:
            self._native = False
            if self._train_files[0].suffix == ".tmb":
                try:
                    from theanompi_tpu_torch.native import NativeBatchLoader

                    loader = NativeBatchLoader(
                        self._train_files,
                        crop=self.crop,
                        mean=self._center_mean()[0],
                        raw_u8=self._u8,
                        depth=self.prefetch_depth,
                        seed=self._seed,
                    )
                    # same contract as _check_batch on the other paths
                    if loader.batch_shape[0] != self.global_batch:
                        raise ValueError(
                            f"pre-batched files hold "
                            f"{loader.batch_shape[0]} images but the "
                            f"configured global batch is "
                            f"{self.global_batch}; re-shard the files "
                            f"(write_batch_files) or fix batch_size"
                        )
                    self._native = loader
                except (RuntimeError, OSError):
                    pass  # no toolchain: thread fallback
        return self._native or None

    def start_prefetch(self, epoch: int) -> None:
        if self.synthetic:
            return
        native = self._native_loader()
        if native is not None:
            native.set_epoch(epoch, np.asarray(self._file_perm, np.int32))
            self._prefetch_pos = 0
            self.feed = "native"
            return
        if self._prefetch is not None:
            self._prefetch.stop()
        self._prefetch = _PrefetchThread(
            self._load_train, self.n_batch_train, self.prefetch_depth
        )
        self._prefetch.start()
        self._prefetch_pos = 0
        self.feed = "thread"

    def train_batch(self, i: int):
        if self.synthetic:
            return self._syn.train_batch(i)
        native = self._native_loader()
        if native is not None and self._prefetch_pos == i:
            self._prefetch_pos += 1
            return native.next()
        if self._prefetch is not None and self._prefetch_pos == i:
            self._prefetch_pos += 1
            return self._prefetch.get()
        return self._load_train(i)  # random access fallback

    def batch_indices(self, i: int):
        """Device-resident dataset support (synthetic mode only; real
        pre-batched files stream per batch)."""
        if self.synthetic:
            return self._syn.batch_indices(i)
        return None

    def epoch_permutation(self):
        if self.synthetic:
            return self._syn.epoch_permutation()
        return None

    def dataset_arrays(self, split: str = "train"):
        if self.synthetic:
            return self._syn.dataset_arrays(split)
        return None  # real files: too big for HBM residency

    def val_batch(self, i: int):
        if self.synthetic:
            return self._syn.val_batch(i)
        x, y = self._read_file(self._val_files[i])
        y = np.asarray(y, np.int32)
        self._check_batch(x, self._val_files[i])
        c = self.crop
        off_h = (x.shape[1] - c) // 2
        off_w = (x.shape[2] - c) // 2
        x = x[:, off_h : off_h + c, off_w : off_w + c]
        if self._u8:
            self._require_u8(x)
            return np.ascontiguousarray(x), y
        return np.asarray(x, np.float32) - self._center_mean(), y


def write_batch_files(
    out_dir: str | Path,
    images: np.ndarray,
    labels: np.ndarray,
    global_batch: int,
    split: str = "train",
    fmt: str = "tmb",
) -> int:
    """Utility: shard (images, labels) into the pre-batched format this
    pipeline reads — ``tmb`` (raw) or ``npz``
    (the reference shipped separate scripts to hickle-ify raw ImageNet;
    this is the rebuild's equivalent)."""
    out = Path(out_dir) / "imagenet_batches" / split
    out.mkdir(parents=True, exist_ok=True)
    n = (len(labels) // global_batch) * global_batch
    for b, start in enumerate(range(0, n, global_batch)):
        x = images[start : start + global_batch]
        y = labels[start : start + global_batch]
        if fmt == "tmb":
            from theanompi_tpu_torch.native import write_tmb

            write_tmb(out / f"batch_{b:06d}.tmb", x, y)
        elif fmt == "npz":
            np.savez(out / f"batch_{b:06d}.npz", x=x, y=y)
        else:
            raise ValueError(f"unknown fmt {fmt!r}; use 'tmb' or 'npz'")
    return n // global_batch
