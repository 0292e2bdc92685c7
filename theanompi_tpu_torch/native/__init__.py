"""Native (C++) runtime components and their ctypes bindings.

A copy of ``theanompi_tpu/native/__init__.py`` with its build moved out
of the source tree:

- ``loader.cc`` (a copy of the JAX package's, no framework in it) is the
  ``.tmb`` batch loader: a pool of worker threads that read each file,
  random-crop, flip and (on the float wire) subtract the mean, and an
  in-order delivery ring.  ``load_native()`` compiles it with the
  system ``g++`` at first use into ``build/theanompi_tpu_torch/`` of the
  checkout (named by a digest of the source and flags, so an edited
  source rebuilds), binds it, and returns the library, or None when
  there is no toolchain or ``TM_NATIVE=0``: the ImageNet module then
  reads through its prefetch thread, whose crops are the loader's.
- ``NativeBatchLoader`` and ``default_loader_threads`` as in JAX.
- ``write_tmb`` / ``read_tmb``: the file format in numpy (``b"TMB1"``,
  the int32 shape ``[N, H, W, C]``, the int32 labels, the uint8
  pixels), so either package reads the other's files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cc"
_BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "theanompi_tpu_torch"
)
_GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the built loader lives: named by a digest of its source and
    the compiler flags."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"tm_native-{h.hexdigest()[:16]}.so"


def _build() -> bool:
    """Compile the loader unless its library is current; False when the
    toolchain is missing or refuses the source."""
    out = library_path()
    if out.exists():
        return True
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)         # atomic: concurrent builds agree
    return True


def load_native() -> ctypes.CDLL | None:
    """Compile (if needed) and bind the native library; None on failure."""
    global _lib, _tried
    if os.environ.get("TM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(library_path()))
        except OSError:
            # a stale or foreign artifact: rebuild once, then give up
            library_path().unlink(missing_ok=True)
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(str(library_path()))
            except OSError:
                return None
        lib.tm_loader_open.restype = ctypes.c_void_p
        lib.tm_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.tm_loader_set_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        lib.tm_loader_next.restype = ctypes.c_int
        lib.tm_loader_next.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.tm_loader_next_u8.restype = ctypes.c_int
        lib.tm_loader_next_u8.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.tm_loader_close.argtypes = [ctypes.c_void_p]
        lib.tm_loader_pinned.restype = ctypes.c_int
        lib.tm_loader_pinned.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeBatchLoader:
    """Ordered, multithreaded batch loader over ``.tmb`` files.

    Drop-in producer for the data pipeline's prefetch slot: call
    ``set_epoch(epoch, perm)`` then ``next()`` exactly once per batch
    in order.  Augmentation (random crop + hflip, and − mean on the
    float wire) runs in the C++ worker pool, deterministic per (seed,
    epoch, position).

    ``TM_LOADER_AFFINITY`` pins worker threads to CPUs: a list like
    ``"0-3,8"`` assigns worker i to list[i % len]; ``"auto"`` spreads
    over all online CPUs.  ``pinned`` reports how many workers were
    actually pinned.
    """

    def __init__(
        self,
        files: list[str | Path],
        crop: int,
        mean: np.ndarray,
        *,
        depth: int = 4,
        n_threads: int | None = None,
        seed: int = 0,
        raw_u8: bool = False,
    ):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.raw_u8 = bool(raw_u8)
        if n_threads is None:
            n_threads = default_loader_threads()
        self.n_threads = int(n_threads)
        paths = [str(f).encode() for f in files]
        blob = b"\x00".join(paths) + b"\x00"
        # probe channel count from the first header to size the mean
        with open(files[0], "rb") as f:
            head = f.read(20)
        if head[:4] != b"TMB1":
            raise ValueError(f"{files[0]} is not a TMB1 batch file")
        n, h, w, c = np.frombuffer(head[4:], np.int32)
        mean_full = np.ascontiguousarray(
            np.broadcast_to(
                mean.reshape(mean.shape[-3:]) if mean.ndim >= 3 else mean,
                (crop, crop, c),
            ),
            np.float32,
        )
        self._h = lib.tm_loader_open(
            blob, len(paths), crop, depth, self.n_threads,
            ctypes.c_uint64(seed), mean_full, mean_full.size,
            1 if raw_u8 else 0,
        )
        if not self._h:
            raise ValueError(
                "tm_loader_open failed: inconsistent/corrupt .tmb files "
                f"or bad crop {crop} for {h}x{w} images"
            )
        self.batch_shape = (int(n), crop, crop, int(c))

    @property
    def pinned(self) -> int:
        """Worker threads successfully pinned (TM_LOADER_AFFINITY)."""
        return int(self._lib.tm_loader_pinned(self._h)) if self._h else 0

    def set_epoch(self, epoch: int, perm: np.ndarray | None = None) -> None:
        if perm is None:
            perm = np.empty(0, np.int32)
        perm = np.ascontiguousarray(perm, np.int32)
        self._lib.tm_loader_set_epoch(self._h, epoch, perm, perm.size)

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        n, cr, _, c = self.batch_shape
        y = np.empty((n,), np.int32)
        if self.raw_u8:
            # u8 wire: crop+flip only; mean-subtract belongs on device
            x = np.empty((n, cr, cr, c), np.uint8)
            rc = self._lib.tm_loader_next_u8(self._h, x, y)
        else:
            x = np.empty((n, cr, cr, c), np.float32)
            rc = self._lib.tm_loader_next(self._h, x, y)
        if rc == 1:
            raise StopIteration("epoch exhausted")
        if rc != 0:
            raise IOError("native loader failed reading a batch file")
        return x, y

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tm_loader_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def default_loader_threads() -> int:
    """TM_LOADER_THREADS, defaulting host-aware: at least 2 threads (a
    file's read then overlaps another's augmentation), one a core on
    wider hosts, up to 8."""
    return int(os.environ.get(
        "TM_LOADER_THREADS", max(2, min(8, os.cpu_count() or 2))
    ))


# -- .tmb format helpers (shared with the pure-Python fallback path) --------

def write_tmb(path: str | Path, x: np.ndarray, y: np.ndarray) -> None:
    """Write one raw batch file: x uint8 [N,H,W,C], y int32 [N].

    Non-uint8 pixels must be losslessly representable as uint8 —
    silently truncating pre-normalized floats would train on garbage.
    """
    if np.asarray(x).dtype != np.uint8:
        xf = np.asarray(x)
        if xf.min() < 0 or xf.max() > 255 or not np.array_equal(
            xf, np.floor(xf)
        ):
            raise ValueError(
                ".tmb stores uint8 pixels; got non-integral or out-of-"
                "range values — pass raw [0,255] images (or use fmt='npz')"
            )
    x = np.ascontiguousarray(x, np.uint8)
    y = np.ascontiguousarray(y, np.int32)
    if x.ndim != 4 or y.shape != (x.shape[0],):
        raise ValueError(f"want x [N,H,W,C] and y [N], got {x.shape} and "
                         f"{y.shape}")
    with open(path, "wb") as f:
        f.write(b"TMB1")
        f.write(np.asarray(x.shape, np.int32).tobytes())
        f.write(y.tobytes())
        f.write(x.tobytes())


def read_tmb(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Pure-numpy reader (memory-mapped pixels)."""
    with open(path, "rb") as f:
        head = f.read(20)
    if head[:4] != b"TMB1":
        raise ValueError(f"{path} is not a TMB1 batch file")
    n, h, w, c = (int(v) for v in np.frombuffer(head[4:], np.int32))
    y = np.fromfile(path, np.int32, count=n, offset=20)
    x = np.memmap(
        path, np.uint8, mode="r", offset=20 + 4 * n, shape=(n, h, w, c)
    )
    return x, y
