"""Sharded checkpoints: per-shard ``.npy`` files and a JSON index.

Port of ``theanompi_tpu/utils/sharded_checkpoint.py``, byte for byte
the same format, so a ``.shards`` checkpoint of either package loads
into the other.  Where the JAX package reads a leaf's shards from a
``jax.Array``'s ``addressable_shards``, the port runs one process a
rank: a leaf is either a whole array (replicated: rank 0 writes it) or
a :class:`ShardedLeaf`, this rank's slice of a global array along axis
0 (the zero1 optimizer shard, the EF residuals), which every rank
writes for itself.

- **Save**: rank r writes its shards into the hidden
  ``.ckpt_<step>.shards.p<r>.tmp`` (rank 0's files as
  ``<group><key>.0.npy``, rank r's prefixed ``p<r>.``) with its index
  fragment ``index.p<r>.json`` (global shape, dtype, each shard's file,
  slice and crc32 digest); at more than one rank, every rank moves its
  files into ``ckpt_<step>.shards`` between barriers and rank 0 commits
  it by dropping ``COMMITTED`` (an uncommitted directory is invisible).
- **Load**: the fragments are merged; a leaf described by a
  :class:`ShardedLeaf` is assembled for this rank's region only, from
  the overlapping shard files opened with ``np.load(mmap_mode='r')`` —
  no rank materialises a full leaf it does not hold.  Each shard file
  read is checked against its digest first.
- **Verify**: ``verify_sharded_checkpoint`` re-hashes every shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from theanompi_tpu_torch.utils.checkpoint import flatten

_SUFFIX = ".shards"
_MARKER = "COMMITTED"


@dataclasses.dataclass
class ShardedLeaf:
    """This rank's slice ``[start, start + len(local))`` along axis 0 of
    a global array of shape ``shape``."""

    local: Any                   # tensor or numpy array
    shape: tuple
    start: int

    @property
    def index(self) -> tuple:
        n = self.local.shape[0]
        return ((self.start, self.start + n),) + tuple(
            (0, d) for d in self.shape[1:])


def _fname(group: str, key: str, i: int) -> str:
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", f"{group}{key}")
    return f"{safe}.{i}.npy"


def _host(x) -> np.ndarray:
    """A leaf as numpy; bfloat16 as its ``uint16`` bits (the npy format
    has no bfloat16; the index keeps the true dtype)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _digest_of(arr: np.ndarray) -> int:
    """``array_digest`` of ``arr`` without a copy of a contiguous
    (e.g. memory-mapped) array."""
    arr = np.ascontiguousarray(arr)
    header = f"{arr.dtype.str}:{arr.shape}".encode()
    return zlib.crc32(arr.reshape(-1).view(np.uint8), zlib.crc32(header)) \
        & 0xFFFFFFFF


def save_sharded_checkpoint(directory: str | Path, step: int, trees: dict,
                            meta: dict | None = None, *, rank: int = 0,
                            world: int = 1,
                            keep_last: int | None = None) -> Path:
    """Write ``{directory}/ckpt_{step}.shards/``: this rank's shards of
    every leaf of ``trees`` (``{group: tree}``); every rank of a
    ``world`` > 1 calls it, in step, on the default process group.
    ``keep_last``: rank 0 then prunes older checkpoints past the newest
    N (``checkpoint.prune_checkpoints``)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"ckpt_{step}{_SUFFIX}"
    tmp = directory / f".ckpt_{step}{_SUFFIX}.p{rank}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    def write(fname, arr) -> int:
        wired = _host(arr)
        np.save(tmp / fname, wired)
        return _digest_of(wired)

    index: dict[str, dict] = {}
    # each shard is copied to the host, written and hashed in a thread
    # (the copies, the writes and zlib drop the GIL): a few leaves in
    # flight at a time
    with ThreadPoolExecutor(4) as ex:
        pending = []
        for group, tree in trees.items():
            for key, leaf in flatten(tree).items():
                sharded = isinstance(leaf, ShardedLeaf)
                arr = leaf.local if sharded else leaf
                shape = tuple(leaf.shape if sharded else np.shape(arr))
                entry = {"shape": list(shape), "dtype": _dtype_name(arr),
                         "shards": []}
                if sharded or rank == 0:
                    fname = _fname(group, key, 0)
                    if rank:
                        fname = f"p{rank}." + fname
                    idx = leaf.index if sharded else tuple(
                        (0, d) for d in shape)
                    entry["shards"].append(
                        {"file": fname, "index": [list(s) for s in idx]})
                    pending.append((entry["shards"][-1],
                                    ex.submit(write, fname, arr)))
                if entry["shards"] or rank == 0:
                    index[f"{group}:{key}"] = entry
        for shard, fut in pending:
            shard["digest"] = fut.result()
    (tmp / f"index.p{rank}.json").write_text(json.dumps(index))
    if meta is not None and rank == 0:
        (tmp / "meta.json").write_text(json.dumps(meta))
    if world > 1:
        # a same-step directory of an earlier run loses its marker and
        # its files before any rank adds fresh ones, so the merged index
        # cannot mix runs; rank 0 commits once every rank moved in
        dist.barrier()
        if rank == 0 and final.exists():
            marker = final / _MARKER
            if marker.exists():
                marker.unlink()
            shutil.rmtree(final)
        dist.barrier()
        final.mkdir(parents=True, exist_ok=True)
        for f in list(tmp.iterdir()):
            os.replace(f, final / f.name)
        tmp.rmdir()
        dist.barrier()
        if rank == 0:
            (final / _MARKER).touch()
        dist.barrier()
    else:
        (tmp / _MARKER).touch()
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    if keep_last is not None and rank == 0:
        # after the commit marker: every rank has moved its files, so
        # collecting older steps cannot race a writer of THIS step
        from theanompi_tpu_torch.utils.checkpoint import prune_checkpoints

        prune_checkpoints(directory, keep_last, protect={final})
    return final


def _merged_index(path: Path) -> dict[str, dict]:
    merged: dict[str, dict] = {}
    for frag in sorted(path.glob("index.p*.json")):
        for k, entry in json.loads(frag.read_text()).items():
            if k in merged:
                merged[k]["shards"].extend(entry["shards"])
            else:
                merged[k] = entry
    if not merged:
        raise FileNotFoundError(f"no index fragments in {path}")
    return merged


def _np_dtype(name: str):
    return np.uint16 if name == "bfloat16" else np.dtype(name)


def _digests_hold(path: Path, shards: list) -> list[bool]:
    """Whether each shard file re-hashes to its stamped digest (a shard
    without one holds), hashed in threads: zlib drops the GIL on large
    buffers, so the files hash in parallel."""
    def one(sh):
        d = sh.get("digest")
        return d is None or _digest_of(
            np.load(path / sh["file"], mmap_mode="r")) == int(d)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        return list(ex.map(one, shards))


class _Shards:
    """The merged index of one checkpoint; its shard files opened
    memory-mapped, each checked against its digest before use."""

    def __init__(self, path: Path, verify: bool = True):
        self.path = Path(path)
        self.index = _merged_index(self.path)
        self.verify = verify

    def parts(self, key: str, req: tuple) -> list:
        """``(shard, src, dst)`` of every shard of leaf ``key`` that
        overlaps the elements ``req`` (``((start, stop), ...)``)."""
        entry = self.index.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        out = []
        for sh in entry["shards"]:
            src, dst = [], []
            for (r0, r1), (s0, s1) in zip(req, sh["index"]):
                lo, hi = max(r0, s0), min(r1, s1)
                if lo >= hi:
                    break
                src.append(slice(lo - s0, hi - s0))
                dst.append(slice(lo - r0, hi - r0))
            else:
                out.append((sh, tuple(src), tuple(dst)))
        return out

    def regions(self, reqs: dict) -> dict:
        """``{key: array}`` of the elements ``reqs[key]`` of each leaf,
        assembled from the shards that overlap them, every shard file
        read checked first."""
        plan = {k: self.parts(k, req) for k, req in reqs.items()}
        if self.verify:
            used = {sh["file"]: sh for parts in plan.values()
                    for sh, _, _ in parts}
            for name, ok in zip(used, _digests_hold(self.path,
                                                    list(used.values()))):
                if not ok:
                    raise ValueError(f"{self.path}: digest mismatch at "
                                     f"{name}")
        opened: dict[str, np.ndarray] = {}
        out = {}
        for key, parts in plan.items():
            entry, req = self.index[key], reqs[key]
            arr = np.empty(tuple(b - a for a, b in req),
                           _np_dtype(entry["dtype"]))
            filled = 0
            for sh, src, dst in parts:
                f = opened.get(sh["file"])
                if f is None:
                    f = opened[sh["file"]] = np.load(
                        self.path / sh["file"], mmap_mode="r")
                arr[dst] = f[src]
                filled += arr[dst].size
            if filled < arr.size:
                raise ValueError(
                    f"checkpoint leaf {key!r}: saved shards do not cover "
                    f"the region {req} of {tuple(entry['shape'])}")
            out[key] = arr
        return out


def load_sharded_checkpoint(path: str | Path, like: dict, *,
                            verify: bool = True) -> tuple[dict, dict]:
    """``({group: {keystr: array}}, meta)`` for the leaves of ``like``
    (``{group: tree}``): a :class:`ShardedLeaf` gets its own region of
    the saved global array, any other leaf the whole array, whose shape
    must be the leaf's."""
    shards = _Shards(Path(path), verify)
    reqs, names = {}, {}
    for group, tree in like.items():
        for key, leaf in flatten(tree).items():
            full = f"{group}:{key}"
            entry = shards.index.get(full)
            if entry is None:
                raise KeyError(f"group {group!r}: checkpoint missing leaf "
                               f"{key!r}")
            shape = tuple(entry["shape"])
            want = tuple(leaf.shape) if isinstance(leaf, ShardedLeaf) \
                else tuple(np.shape(leaf))
            if want != shape:
                raise ValueError(f"checkpoint leaf {full!r} has shape "
                                 f"{shape}, expected {want}")
            reqs[full] = leaf.index if isinstance(leaf, ShardedLeaf) \
                else tuple((0, d) for d in shape)
            names[full] = (group, key)
    got = shards.regions(reqs)
    out: dict[str, dict] = {g: {} for g in like}
    for full, arr in got.items():
        group, key = names[full]
        out[group][key] = arr
    meta_path = Path(path) / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return out, meta


def load_sharded_group(path: str | Path, group: str) -> dict[str, Any]:
    """One group's FULL arrays keyed by leaf path at their saved global
    shapes (the elastic loader reshards them on the host)."""
    shards = _Shards(Path(path))
    prefix = f"{group}:"
    got = shards.regions({k: tuple((0, d) for d in entry["shape"])
                          for k, entry in shards.index.items()
                          if k.startswith(prefix)})
    if not got:
        raise KeyError(f"checkpoint {path} has no group {group!r}")
    return {k[len(prefix):]: a for k, a in got.items()}


def verify_sharded_checkpoint(path: str | Path) -> bool:
    """Marker present, index fragments parse, every shard file re-hashes
    to its save-time digest.  Never raises."""
    try:
        p = Path(path)
        if not is_sharded_checkpoint(p):
            return False
        shards = [sh for entry in _merged_index(p).values()
                  for sh in entry["shards"]]
        return all(_digests_hold(p, shards))
    except Exception:
        return False


def is_sharded_checkpoint(path: str | Path) -> bool:
    """True for a COMMITTED sharded checkpoint directory."""
    p = Path(path)
    return str(path).endswith(_SUFFIX) and p.is_dir() and (
        p / _MARKER).exists()
