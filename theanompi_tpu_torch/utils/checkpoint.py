"""Writer and reader of the JAX package's npz checkpoints.

Port of ``theanompi_tpu/utils/checkpoint.py``.  A checkpoint is
``ckpt_<step>.npz`` holding every leaf of the saved trees under
``"<group>:" + jax.tree_util.keystr(path)`` — e.g.
``params:['layers'][0]['wq']``, ``opt_state:['m']['embed']``,
``opt_state:['t']`` — beside a ``ckpt_<step>.json`` sidecar with the
metadata (epoch, lr, world stamps, recorder state) and a ``_digests``
map stamping each array's crc32 (``array_digest``).  The keys are
written and parsed here without jax, so a checkpoint of either package
loads into the other; the digests are verified before any array is
used.

A ``ckpt_<step>.shards`` directory (``utils/sharded_checkpoint.py``:
one ``.npy`` a shard, index fragments, a ``COMMITTED`` marker) is the
other format, which zero1 runs of more than one rank write; the
functions here that pick and read a checkpoint take either
(``checkpoints``, ``checkpoint_meta``, ``load_trees``,
``load_raw_group``, ``load_latest_params``).

Validation and retention, as in the JAX package: ``verify_checkpoint``
deep-probes one checkpoint of either format, ``latest_checkpoint(
validate=True)`` returns the newest that passes and renames each
corrupt candidate it met to ``*.corrupt`` (``quarantine_checkpoint``:
kept for a post-mortem, never deleted, never found again), and
``prune_checkpoints`` (``save_checkpoint(keep_last=N)``) bounds how
many committed checkpoints a run that restarts many times leaves.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_CKPT_RE = re.compile(r"ckpt_(\d+)(\.npz|\.shards)")
#: threads that read and hash a checkpoint's arrays (file reads and
#: zlib drop the GIL)
_IO_THREADS = 8
_KEY_RE = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def array_digest(arr: np.ndarray) -> int:
    """crc32 over the raw bytes, seeded with dtype and shape — the
    digest the JAX package stamps at save time."""
    arr = np.ascontiguousarray(arr)
    header = f"{arr.dtype.str}:{arr.shape}".encode()
    # the bytes as a view (no copy), so threads can hash a large state
    return zlib.crc32(arr.reshape(-1).view(np.uint8),
                      zlib.crc32(header)) & 0xFFFFFFFF


def parse_keystr(key: str) -> list:
    """``"['layers'][0]['wq']"`` → ``["layers", 0, "wq"]``."""
    parts = []
    pos = 0
    for m in _KEY_RE.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unparseable checkpoint key {key!r}")
        parts.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"unparseable checkpoint key {key!r}")
    return parts


def _listify(node):
    """Nested dicts whose keys are the ints 0..n-1 become lists (the
    JAX tree's sequence nodes, e.g. ``params['layers']``)."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(
                f"checkpoint list indices {sorted(out)} have gaps"
            )
        return [out[i] for i in range(len(out))]
    return out


def _read_checked(path: Path, name: str, digests: dict) -> np.ndarray:
    """One array of an npz, read through the zip (its member's CRC-32 is
    checked as it is read to its end) and held to its digest, when
    ``digests`` has any.  Each call opens the file, so threads may read
    members side by side."""
    with zipfile.ZipFile(path) as zf, zf.open(f"{name}.npy") as f:
        arr = np.lib.format.read_array(f, allow_pickle=False)
    if digests and array_digest(arr) != int(digests[name]):
        raise ValueError(f"{path}: digest mismatch at {name!r}")
    return arr


def _read_npz(path: Path, names, digests: dict) -> dict[str, np.ndarray]:
    """``{name: _read_checked(...)}`` of ``names``, in threads."""
    with ThreadPoolExecutor(_IO_THREADS) as ex:
        return dict(zip(names, ex.map(
            lambda n: _read_checked(path, n, digests), names)))


def _npz_names(path: Path) -> list[str]:
    """The array names of an npz (its members less ``.npy``)."""
    with zipfile.ZipFile(path) as zf:
        return [n[:-4] for n in zf.namelist() if n.endswith(".npy")]


def load_group(path: str | Path, group: str = "params",
               flat: bool = False) -> dict:
    """One group of an npz checkpoint as a nested dict/list tree of
    numpy arrays, or with ``flat=True`` as ``{keystr: array}`` (a tree
    whose empty nodes left no key, such as the ``{}`` of a stateless
    layer in a list of layers, is rebuilt by its reader).  Every array
    of the group must match its sidecar digest when the sidecar stamps
    digests (``ValueError`` otherwise; checkpoints from before digest
    stamping load unchecked, as in the JAX package)."""
    path = Path(path)
    digests = {}
    meta_path = path.with_suffix(".json")
    if meta_path.exists():
        digests = json.loads(meta_path.read_text()).get("_digests", {}) or {}
    prefix = f"{group}:"
    names = [k for k in _npz_names(path) if k.startswith(prefix)]
    if not names:
        raise KeyError(f"checkpoint {path} has no group {group!r}")
    missing = [k for k in names if digests and k not in digests]
    if missing:
        raise ValueError(f"{path}: no digest for {missing[0]!r}")
    tree = {k[len(prefix):]: a
            for k, a in _read_npz(path, names, digests).items()}
    return tree if flat else unflatten(tree)


def checkpoints(directory: Path) -> list[Path]:
    """Checkpoints under ``directory`` (npz files and committed
    ``.shards`` directories), newest step first."""
    from theanompi_tpu_torch.utils.sharded_checkpoint import (
        is_sharded_checkpoint,
    )

    found = []
    for p in directory.iterdir():
        m = _CKPT_RE.fullmatch(p.name)
        if m and (m.group(2) == ".npz" or is_sharded_checkpoint(p)):
            found.append((int(m.group(1)), p.stat().st_mtime, p))
    found.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [p for _, _, p in found]


def keystr(path) -> str:
    """``["layers", 0, "wq"]`` -> ``"['layers'][0]['wq']"`` (the
    inverse of :func:`parse_keystr`)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def flatten(tree, prefix=()) -> dict:
    """Leaves of a nested dict/list tree keyed by keystr, in the JAX
    package's leaf order (dict keys sorted, sequences in order); an
    empty tuple (SGD's optimizer state) has no leaves, a bare leaf the
    key ``""``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(flatten(x, prefix + (i,)))
        return out
    return {keystr(prefix): tree}


def tree_to_flat(tree) -> dict[str, np.ndarray]:
    """:func:`flatten` with every leaf as a numpy array."""
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def unflatten(flat: dict):
    """Inverse of :func:`flatten` for ``{keystr: array}`` (int keys
    become lists); the key ``""`` is a bare leaf."""
    if set(flat) == {""}:
        return flat[""]
    tree: dict = {}
    for name, arr in flat.items():
        *parents, leaf = parse_keystr(name)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return _listify(tree)


def save_checkpoint(directory: str | Path, step: int, trees: dict,
                    meta: dict | None = None,
                    keep_last: int | None = None) -> Path:
    """Write ``{directory}/ckpt_{step}.npz`` and its ``.json`` sidecar
    (metadata plus per-array digests), the sidecar first and the npz
    renamed into place, as the JAX package does.  ``keep_last`` prunes
    older checkpoints past the newest N (never the one just written;
    quarantined ``*.corrupt`` files are never touched)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = {}
    for group, tree in trees.items():
        for k, v in tree_to_flat(tree).items():
            flat[f"{group}:{k}"] = v
    sidecar = dict(meta or {})
    with ThreadPoolExecutor(_IO_THREADS) as ex:
        sidecar["_digests"] = dict(zip(flat, ex.map(array_digest,
                                                     flat.values())))
    (directory / f"ckpt_{step}.json").write_text(json.dumps(sidecar))
    tmp = directory / f".ckpt_{step}.npz.tmp"
    final = directory / f"ckpt_{step}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    if keep_last is not None:
        prune_checkpoints(directory, keep_last, protect={final})
    return final


def verify_checkpoint(path: str | Path) -> bool:
    """Deep-probe one committed checkpoint: structurally readable AND
    every array matches its save-time digest (a ``.shards`` directory:
    ``verify_sharded_checkpoint``).  Checkpoints from before digest
    stamping verify structurally only.  Never raises — any failure to
    read is a failed verification."""
    path = Path(path)
    try:
        if path.name.endswith(".shards"):
            from theanompi_tpu_torch.utils.sharded_checkpoint import (
                verify_sharded_checkpoint,
            )

            return verify_sharded_checkpoint(path)
        digests: dict = {}
        meta_path = path.with_suffix(".json")
        if meta_path.exists():
            digests = json.loads(meta_path.read_text()).get(
                "_digests", {}) or {}
        names = _npz_names(path)
        if digests and set(digests) != set(names):
            return False  # missing/extra member = truncation/mixup
        with ThreadPoolExecutor(_IO_THREADS) as ex:  # a corrupt member raises
            for _ in ex.map(lambda n: _read_checked(path, n, digests).size,
                            names):
                pass
        return True
    except Exception:
        return False


def quarantine_checkpoint(path: str | Path) -> Path:
    """Rename a corrupt checkpoint (and its sidecar) to ``*.corrupt``
    — undiscoverable by ``latest_checkpoint`` but kept on disk for a
    post-mortem.  Never deletes."""
    path = Path(path)
    dst = path.with_name(path.name + ".corrupt")
    n = 0
    while dst.exists():  # repeat corruption of the same step
        n += 1
        dst = path.with_name(f"{path.name}.corrupt{n}")
    os.replace(path, dst)
    if path.suffix == ".npz":
        sidecar = path.with_suffix(".json")
        if sidecar.exists():
            os.replace(sidecar, sidecar.with_name(
                sidecar.name + (f".corrupt{n}" if n else ".corrupt")))
    return dst


def latest_checkpoint(directory: str | Path,
                      validate: bool = False) -> Path | None:
    """Newest checkpoint in ``directory`` — either format.
    ``validate=True`` deep-probes candidates newest first
    (``verify_checkpoint``) and returns the newest one that PASSES; a
    corrupt candidate is quarantined (renamed ``*.corrupt``, never
    deleted), so a resume falls back to the previous valid checkpoint
    instead of dying or silently diverging on a post-commit bit flip.
    The ranks of a run call it through ``models.base.resume_checkpoint``
    (rank 0 alone, so no two rename one file)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    for p in checkpoints(directory):
        if not validate or verify_checkpoint(p):
            return p
        q = quarantine_checkpoint(p)
        print(f"checkpoint: {p.name} failed validation — quarantined as "
              f"{q.name}, falling back to the previous checkpoint",
              flush=True)
    return None


def prune_checkpoints(directory: str | Path, keep_last: int,
                      protect: set | None = None) -> list[Path]:
    """Delete committed checkpoints beyond the newest ``keep_last``.
    The just-written checkpoint is passed in ``protect`` by savers;
    quarantined ``*.corrupt`` files never match and are never
    collected.  Returns the deleted paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    directory = Path(directory)
    protect = {Path(p) for p in (protect or set())}
    removed: list[Path] = []
    for p in checkpoints(directory)[keep_last:]:
        if p in protect:
            continue
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()
            sidecar = p.with_suffix(".json")
            if sidecar.exists():
                sidecar.unlink()
        removed.append(p)
    return removed


def checkpoint_meta(path: str | Path) -> dict:
    """The metadata of a checkpoint of either format, without the
    digests and without reading an array (``{}`` when there is
    none)."""
    path = Path(path)
    meta_path = (path / "meta.json" if path.name.endswith(".shards")
                 else path.with_suffix(".json"))
    if not meta_path.exists():
        return {}
    meta = json.loads(meta_path.read_text())
    meta.pop("_digests", None)
    return meta


def load_trees(path: str | Path, like: dict) -> dict:
    """``{group: {keystr: array}}`` of the groups of ``like`` (``{group:
    tree}``) from a checkpoint of either format, every array checked
    against its digest.  A ``ShardedLeaf`` of ``like`` gets only its
    own region of the saved global array (from a ``.shards``
    checkpoint without reading the rest); a group that is ``()`` in
    ``like`` (SGD's state) loads as ``()``."""
    from theanompi_tpu_torch.utils.sharded_checkpoint import (
        ShardedLeaf,
        is_sharded_checkpoint,
        load_sharded_checkpoint,
    )

    path = Path(path)
    if is_sharded_checkpoint(path):
        trees, _ = load_sharded_checkpoint(path, like)
    else:
        trees = {}
        for group, tree in like.items():
            want = flatten(tree)
            if not want:
                trees[group] = ()
                continue
            got = load_group(path, group, flat=True)
            if set(got) != set(want):
                raise KeyError(
                    f"group {group!r}: checkpoint leaves do not match: "
                    f"missing {sorted(set(want) - set(got))[:5]}, "
                    f"unexpected {sorted(set(got) - set(want))[:5]}")
            for k, leaf in want.items():
                if isinstance(leaf, ShardedLeaf):
                    if got[k].shape != tuple(leaf.shape):
                        raise ValueError(
                            f"checkpoint leaf {group}:{k} has shape "
                            f"{got[k].shape}, expected {leaf.shape}")
                    got[k] = got[k][tuple(slice(a, b)
                                          for a, b in leaf.index)]
            trees[group] = got
    return {g: (t if flatten(like[g]) else ()) for g, t in trees.items()}


def load_raw_group(path: str | Path, group: str) -> dict[str, np.ndarray]:
    """One group's arrays keyed by leaf path at their SAVED (global)
    shapes, from a checkpoint of either format: the elastic loader
    reshards them on the host (``utils/reshard.py``)."""
    from theanompi_tpu_torch.utils.sharded_checkpoint import (
        is_sharded_checkpoint,
        load_sharded_group,
    )

    if is_sharded_checkpoint(path):
        return load_sharded_group(path, group)
    return load_group(path, group, flat=True)


def load_latest(directory: str | Path, groups: tuple[str, ...],
                flat: bool = False):
    """``(path, {group: tree}, meta)`` of the newest checkpoint (npz or
    ``.shards``) under ``directory`` whose groups all verify, or None
    when there is none; ``flat`` as in :func:`load_group`.  A group with
    no arrays (SGD's empty optimizer state) loads as ``()``.  A
    checkpoint that fails its digests is reported and skipped (an older
    one is used)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    for path in checkpoints(directory):
        try:
            trees = {}
            for g in groups:
                try:
                    got = load_raw_group(path, g)
                except KeyError:
                    trees[g] = ()
                    continue
                trees[g] = got if flat else unflatten(got)
            return path, trees, checkpoint_meta(path)
        except (ValueError, OSError) as e:
            print(f"checkpoint: skipping {path.name}: {e}", flush=True)
    return None


def load_latest_params(directory: Path) -> dict:
    """The ``params`` tree of the newest checkpoint under ``directory``
    (npz or ``.shards``) that verifies; an older one is used when a
    newer one fails its digests (which is reported, not deleted)."""
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    for path in checkpoints(directory):
        try:
            return unflatten(load_raw_group(path, "params"))
        except (ValueError, OSError) as e:
            print(f"checkpoint: skipping {path.name}: {e}", flush=True)
    raise FileNotFoundError(f"no loadable checkpoint under {directory}")
