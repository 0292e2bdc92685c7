"""Producer-independent augmentation randomness.

A copy of ``theanompi_tpu/models/data/aug_rng.py`` (numpy only).  The
draws are the C++ loader's (``native/loader.cc``), so a batch is the
same whichever producer or package serves it.

A batch's crops/flips must be a PURE FUNCTION of
``(seed, epoch, position-in-epoch, image-index)`` no matter which
producer serves it — the C++ ``.tmb`` loader, the prefetch thread, or
the random-access fallback (ADVICE r1: the producers used different
RNG schemes, so out-of-order access changed the augmentation).

The derivation is the public splitmix64 mixer, chosen because it is
trivially identical in vectorized numpy (here) and scalar C++
(``native/loader.cc``) — keep the two implementations in sync.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _C1).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * _C2).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * _C3).astype(np.uint64)
    return x ^ (x >> np.uint64(31))


def crop_flip_draws(
    seed: int, epoch: int, seq: int, n: int, h: int, w: int, crop: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-image ``(row0, col0, flip)`` for batch position ``seq`` of
    ``epoch`` — bit-identical to the native loader's draws."""
    k = np.arange(1, n + 1, dtype=np.uint64)
    # 0-d arrays, not numpy scalars: scalar uint64 multiplies emit
    # "overflow encountered" RuntimeWarnings even though the wrap is
    # the intended semantics; array ops wrap silently
    ep = np.asarray(epoch, np.uint64)
    sq = np.asarray(seq + 1, np.uint64)
    base = (
        np.asarray(seed, np.uint64)
        ^ (_C1 * ep)
        ^ (_C2 * sq)
        ^ (_C3 * k)
    ).astype(np.uint64)
    ii = _splitmix64(base ^ np.uint64(1)) % np.uint64(h - crop + 1)
    jj = _splitmix64(base ^ np.uint64(2)) % np.uint64(w - crop + 1)
    flip = (_splitmix64(base ^ np.uint64(3)) & np.uint64(1)).astype(bool)
    return ii.astype(np.int64), jj.astype(np.int64), flip
