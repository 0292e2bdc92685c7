"""The ``.tmb`` batch-file format (numpy only).

``write_tmb`` and ``read_tmb`` are copies of the two numpy functions of
``theanompi_tpu/native/__init__.py``: a file is ``b"TMB1"``, the int32
shape ``[N, H, W, C]``, the int32 labels ``[N]`` and the uint8 pixels,
so either package reads the other's files.  The JAX package's C++
loader (``loader.cc`` behind ``NativeBatchLoader``) is not ported yet
(ROADMAP.md A5): ``.tmb`` files go through the ImageNet module's
prefetch thread, whose crops are the loader's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


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
