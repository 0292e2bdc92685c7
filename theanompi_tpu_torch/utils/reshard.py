"""Elastic resharding of flat exchange layouts (host-side, pure numpy).

A copy of ``theanompi_tpu/utils/reshard.py``, whose tree walks become
the port's flat key maps: a group is ``{keystr: array}`` (the
``"<group>:" + keystr`` keys of ``utils/checkpoint.py``) in and out.

A zero1 optimizer shard, an EF residual, and a bucketed flat buffer
are all stamped with the ``(padded, bucket_len)`` layout they were
written under (``models/base.py`` stamps ``zero1_layout`` /
``ef_layout``; ``parallel/exchange.flat_layout`` is THE rule).  Until
this module, a resume under a different data-parallel width REFUSED —
the flat shard order is layout-dependent, so loading blindly would
pair adam/momentum rows with the wrong parameters.

This module makes the refusal unnecessary for an ELASTIC resume: it
gathers a saved flat buffer back to master (pack) order, drops the
padding, and re-scatters under the new world's layout — exactly, as a
permutation, so params and gathered optimizer state stay bitwise.

The two storage layouts (see ``exchange.scatter_update_gather``):

- **monolithic** (``bucket_len == 0``): device *d* of *N* holds pack
  elements ``[d*shard_len, (d+1)*shard_len)`` — storage order IS pack
  order.
- **bucketed**: device *d*'s shard is bucket-major — its rows
  ``[i*bs, (i+1)*bs)`` are its 1/N slice of bucket *i*, which covers
  pack elements ``[i*bucket_len + d*bs, i*bucket_len + (d+1)*bs)``.
  Storage index ``d*shard_len + i*bs + j`` ↔ pack index
  ``i*bucket_len + d*bs + j`` — a reshape/transpose, no gather loop.

EF residuals differ per kind:

- ``r1`` (local-grad residual) is PER-DEVICE state in plain pack
  order (global ``[n*padded]``).  Across a world change devices
  appear/disappear, so the per-device split is meaningless — what
  matters for convergence is the residual's contribution to the
  MEAN-reduce, ``(sum_d r1_d) / n`` (each device adds its residual
  to its local grad before the sum, which is then divided by the
  world size).  The reshard conserves that contribution exactly:
  the summed residual, scaled by ``n_new / n_old``, lands on the
  new world's shard 0, zeros elsewhere — the next exchange then
  injects ``total * (n_new/n_old) / n_new == total / n_old``, the
  same mean mass the old world would have re-injected.
- ``r2`` (shard-owner residual of the reduced-mean compression) is
  PER-ELEMENT state with exactly one owner per element — ownership
  moves with the layout, values survive: the same permutation as the
  optimizer shard.

What still refuses (see docs/RESILIENCE.md): flat buffers spanning
model/pipe axes (Llama tp/pp > 1 packs differ per model shard), MoE
per-group shards, cross-compression residual transfer, and
checkpoints without a ``world_size`` stamp when the saved layout was
bucketed (the storage permutation needs the old shard count).
"""

from __future__ import annotations

import numpy as np

#: why a flat buffer longer than its stamped ``padded`` (one pack a model
#: shard or stage) refuses to reshard, in the JAX reshard's words
SPANNING_REFUSAL = ("flat buffers spanning model/pipe axes (tp/pp-sharded "
                    "zero1 packs) cannot reshard over the data axis alone")


def _check_layout(n_shards: int | None, padded: int, bucket_len: int,
                  *, what: str) -> None:
    if padded <= 0:
        raise ValueError(f"{what}: padded must be > 0, got {padded}")
    if n_shards is not None and padded % n_shards:
        raise ValueError(
            f"{what}: padded {padded} is not a multiple of the shard "
            f"count {n_shards} — not a flat exchange layout"
        )
    if bucket_len:
        if n_shards is None:
            raise ValueError(
                f"{what}: the saved layout is bucketed "
                f"(bucket_len={bucket_len}) but the checkpoint carries "
                f"no world_size stamp — the storage permutation needs "
                f"the shard count it was written under.  Checkpoints "
                f"written before the elastic loader lack the stamp "
                f"and cannot reshard; resume at the original dp once, "
                f"re-save, then reshard."
            )
        if bucket_len % n_shards or padded % bucket_len:
            raise ValueError(
                f"{what}: inconsistent layout (padded={padded}, "
                f"bucket_len={bucket_len}, n_shards={n_shards})"
            )


def storage_to_pack(buf: np.ndarray, n_shards: int | None,
                    bucket_len: int) -> np.ndarray:
    """Gather a flat buffer from its sharded STORAGE order back to
    master (pack) order.  ``bucket_len == 0`` (monolithic) is the
    identity; bucketed layouts undo the bucket-major per-shard
    interleave with one reshape/transpose."""
    buf = np.asarray(buf)
    _check_layout(n_shards, buf.shape[0], bucket_len, what="storage_to_pack")
    if not bucket_len or bucket_len >= buf.shape[0]:
        return np.array(buf)
    n_buckets = buf.shape[0] // bucket_len
    bs = bucket_len // n_shards
    # storage [d*shard_len + i*bs + j] -> pack [i*bucket_len + d*bs + j]
    return (
        buf.reshape(n_shards, n_buckets, bs)
        .transpose(1, 0, 2)
        .reshape(-1)
    )


def pack_to_storage(buf: np.ndarray, n_shards: int | None,
                    bucket_len: int) -> np.ndarray:
    """Inverse of ``storage_to_pack``: scatter a pack-order buffer
    into the sharded storage order of ``(n_shards, bucket_len)``."""
    buf = np.asarray(buf)
    _check_layout(n_shards, buf.shape[0], bucket_len, what="pack_to_storage")
    if not bucket_len or bucket_len >= buf.shape[0]:
        return np.array(buf)
    n_buckets = buf.shape[0] // bucket_len
    bs = bucket_len // n_shards
    return (
        buf.reshape(n_buckets, n_shards, bs)
        .transpose(1, 0, 2)
        .reshape(-1)
    )


def reshard_flat(
    buf: np.ndarray,
    *,
    size: int,
    old: tuple[int | None, int, int],
    new: tuple[int, int, int],
) -> np.ndarray:
    """Re-lay a flat buffer saved under ``old = (n_shards, padded,
    bucket_len)`` into ``new``'s storage order.  ``size`` is the live
    element count (the parameter-pack length); the pad tail is zeros
    by construction (zero grads leave momentum/adam/residual rows at
    exactly zero) and is dropped/regrown, never transplanted."""
    buf = np.asarray(buf)
    n_o, p_o, b_o = old
    n_n, p_n, b_n = new
    if buf.shape != (p_o,):
        raise ValueError(
            f"reshard_flat: buffer shape {buf.shape} does not match "
            f"the stamped layout (padded={p_o}) — {SPANNING_REFUSAL}"
        )
    if not 0 < size <= min(p_o, p_n):
        raise ValueError(
            f"reshard_flat: live size {size} does not fit layouts "
            f"(padded {p_o} -> {p_n})"
        )
    pack = storage_to_pack(buf, n_o, b_o)
    if p_n == p_o and not np.shares_memory(pack, buf):
        out = pack              # a fresh copy: the live rows stay put
        out[size:] = 0
    else:
        out = np.zeros((p_n,), buf.dtype)
        out[:size] = pack[:size]
    return pack_to_storage(out, n_n, b_n)


def reshard_flat_tree(
    raw: dict[str, np.ndarray],
    like: dict[str, tuple],
    *,
    size: int,
    old: tuple[int | None, int, int],
    new: tuple[int, int, int],
) -> dict[str, np.ndarray]:
    """Reshard a saved flat-buffer group (zero1 optimizer state) onto
    the global shapes of ``like`` (``{keystr: shape}``).  ``raw`` maps
    the saved group's leaf keys to host arrays.  Flat ``[padded_old]``
    leaves reshard; scalar leaves (adam's step counter) pass through;
    anything else refuses."""
    _, p_o, _ = old
    _, p_n, _ = new
    out = {}
    for key, want in like.items():
        if key not in raw:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.asarray(raw[key])
        want = tuple(want)
        if want == (p_n,) and arr.shape == (p_o,):
            out[key] = reshard_flat(arr, size=size, old=old, new=new)
        elif arr.shape == want:
            out[key] = arr
        else:
            raise ValueError(
                f"reshard: leaf {key!r} has saved shape {arr.shape}, "
                f"expected {want} or the stamped flat layout "
                f"({p_o},) — not a data-axis flat buffer"
            )
    return out


def reshard_ef_tree(
    raw: dict[str, np.ndarray],
    like: dict[str, tuple],
    *,
    size: int,
    old: tuple[int | None, int, int],
    new: tuple[int, int, int],
) -> dict[str, np.ndarray]:
    """Reshard a saved EF-residual group (``{"r1"[, "r2"]}``) onto the
    global shapes of ``like`` (``{keystr: shape}``).  ``r1`` conserves
    the summed residual mass onto the new shard 0 (per-device state;
    see module docstring); ``r2`` permutes like the optimizer shard
    (per-element state)."""
    n_o, p_o, b_o = old
    n_n, p_n, b_n = new
    out = {}
    for key, want in like.items():
        if key not in raw:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.asarray(raw[key])
        want = tuple(want)
        if "r1" in key:
            n_old = n_o if n_o is not None else arr.shape[0] // p_o
            if arr.shape != (n_old * p_o,) or want != (n_n * p_n,):
                raise ValueError(
                    f"reshard: EF residual {key!r} has saved shape "
                    f"{arr.shape}, stamped layout says "
                    f"({n_old}*{p_o},) -> expected target "
                    f"({n_n}*{p_n},), got {want}"
                )
            rows = arr.reshape(n_old, p_o).astype(np.float32)
            total = np.sum(rows[:, :size], axis=0)
            r1 = np.zeros((n_n * p_n,), np.float32)
            # shard 0 carries the mass, scaled so the next exchange's
            # mean-reduce injects the SAME contribution the old world
            # would have: total * (n_new/n_old) / n_new == total/n_old
            r1[:size] = total * (n_n / n_old)
            out[key] = r1
        elif "r2" in key:
            out[key] = reshard_flat(arr, size=size, old=old, new=new)
        else:
            raise ValueError(
                f"reshard: unknown EF-residual leaf {key!r} — the "
                f"compressed exchange carries only r1/r2"
            )
    return out
