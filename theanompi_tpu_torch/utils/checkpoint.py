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
used.  Sharded (``.shards``) checkpoints are not read or written yet
(ROADMAP.md A8).
"""

from __future__ import annotations

import json
import os
import re
import zlib
from pathlib import Path

import numpy as np

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz")
_KEY_RE = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def array_digest(arr: np.ndarray) -> int:
    """crc32 over the raw bytes, seeded with dtype and shape — the
    digest the JAX package stamps at save time."""
    arr = np.ascontiguousarray(arr)
    header = f"{arr.dtype.str}:{arr.shape}".encode()
    return zlib.crc32(arr.tobytes(), zlib.crc32(header)) & 0xFFFFFFFF


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
    tree: dict = {}
    with np.load(path) as z:
        names = [k for k in z.files if k.startswith(prefix)]
        if not names:
            raise KeyError(f"checkpoint {path} has no group {group!r}")
        for name in names:
            arr = z[name]
            if digests:
                if name not in digests:
                    raise ValueError(f"{path}: no digest for {name!r}")
                if array_digest(arr) != int(digests[name]):
                    raise ValueError(f"{path}: digest mismatch at {name!r}")
            if flat:
                tree[name[len(prefix):]] = arr
                continue
            *parents, leaf = parse_keystr(name[len(prefix):])
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return tree if flat else _listify(tree)


def checkpoints(directory: Path) -> list[Path]:
    """npz checkpoints under ``directory``, newest step first."""
    found = []
    for p in directory.iterdir():
        m = _CKPT_RE.fullmatch(p.name)
        if m:
            found.append((int(m.group(1)), p.stat().st_mtime, p))
    found.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [p for _, _, p in found]


def keystr(path) -> str:
    """``["layers", 0, "wq"]`` -> ``"['layers'][0]['wq']"`` (the
    inverse of :func:`parse_keystr`)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def tree_to_flat(tree, prefix=()) -> dict[str, np.ndarray]:
    """Leaves of a nested dict/list tree of arrays keyed by keystr;
    an empty tuple (SGD's optimizer state) has no leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_to_flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(tree_to_flat(x, prefix + (i,)))
        return out
    return {keystr(prefix): np.asarray(tree)}


def save_checkpoint(directory: str | Path, step: int, trees: dict,
                    meta: dict | None = None) -> Path:
    """Write ``{directory}/ckpt_{step}.npz`` and its ``.json`` sidecar
    (metadata plus per-array digests), the sidecar first and the npz
    renamed into place, as the JAX package does."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = {}
    for group, tree in trees.items():
        for k, v in tree_to_flat(tree).items():
            flat[f"{group}:{k}"] = v
    sidecar = dict(meta or {})
    sidecar["_digests"] = {k: array_digest(v) for k, v in flat.items()}
    (directory / f"ckpt_{step}.json").write_text(json.dumps(sidecar))
    tmp = directory / f".ckpt_{step}.npz.tmp"
    final = directory / f"ckpt_{step}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    return final


def checkpoint_meta(path: str | Path) -> dict:
    """The sidecar metadata of a checkpoint, without the digests
    (``{}`` when there is no sidecar)."""
    meta_path = Path(path).with_suffix(".json")
    if not meta_path.exists():
        return {}
    meta = json.loads(meta_path.read_text())
    meta.pop("_digests", None)
    return meta


def load_latest(directory: str | Path, groups: tuple[str, ...],
                flat: bool = False):
    """``(path, {group: tree}, meta)`` of the newest checkpoint under
    ``directory`` whose groups all verify, or None when there is none;
    ``flat`` as in :func:`load_group`.  A group with no arrays (SGD's
    empty optimizer state) loads as ``()``.  A checkpoint that fails its digests is reported and
    skipped (an older one is used)."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    for path in checkpoints(directory):
        try:
            trees = {}
            for g in groups:
                try:
                    trees[g] = load_group(path, g, flat)
                except KeyError:
                    trees[g] = ()
            return path, trees, checkpoint_meta(path)
        except (ValueError, OSError) as e:
            print(f"checkpoint: skipping {path.name}: {e}", flush=True)
    return None


def load_latest_params(directory: Path) -> dict:
    """The ``params`` tree of the newest checkpoint under ``directory``
    that verifies; an older one is used when a newer one fails its
    digests (which is reported, not deleted)."""
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    for path in checkpoints(directory):
        try:
            return load_group(path, "params")
        except (ValueError, OSError) as e:
            print(f"checkpoint: skipping {path.name}: {e}", flush=True)
    raise FileNotFoundError(f"no loadable npz checkpoint under {directory}")
