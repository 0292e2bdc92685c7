"""Reader of the JAX package's npz checkpoints.

Port (reader only) of ``theanompi_tpu/utils/checkpoint.py``.  A
checkpoint is ``ckpt_<step>.npz`` holding every leaf of the saved trees
under ``"<group>:" + jax.tree_util.keystr(path)`` — e.g.
``params:['layers'][0]['wq']`` — beside a ``ckpt_<step>.json`` sidecar
whose ``_digests`` map stamps each array's crc32 (``array_digest``).
The keys are parsed here without jax; the digests are verified before
any array is used.  Sharded (``.shards``) checkpoints are not read yet.
"""

from __future__ import annotations

import json
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


def load_group(path: str | Path, group: str = "params") -> dict:
    """One group of an npz checkpoint as a nested dict/list tree of
    numpy arrays.  Every array of the group must match its sidecar
    digest when the sidecar stamps digests (``ValueError`` otherwise;
    checkpoints from before digest stamping load unchecked, as in the
    JAX package)."""
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
            *parents, leaf = parse_keystr(name[len(prefix):])
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return _listify(tree)


def checkpoints(directory: Path) -> list[Path]:
    """npz checkpoints under ``directory``, newest step first."""
    found = []
    for p in directory.iterdir():
        m = _CKPT_RE.fullmatch(p.name)
        if m:
            found.append((int(m.group(1)), p.stat().st_mtime, p))
    found.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [p for _, _, p in found]


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
