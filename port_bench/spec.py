"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here knows a cell: the configuration, the traffic mix, the
traffic generator the mix names, the limits and the per-layer metric
readers are files named after the entries, so a later change adds a
cell, a traffic shape or a metric by adding files.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

#: the benchmark's own folder; the repository root is its parent
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None,
              bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark at ``root``: its configuration
    file (the ``file`` its ``configs`` entry gives), its traffic mix
    ``traffic/<mix>.json``, its limits ``limits/<cell>.json`` and the
    metrics that apply to it."""
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = confs[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _load_module(folder: str, name: str, bench_dir: Path):
    """``<bench_dir>/<folder>/<name>.py``, loaded by path (a name may
    hold dots)."""
    path = Path(bench_dir) / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench_dir: Path = HERE):
    """The ``read(records) -> float | None`` of ``metrics/<metric>.py``."""
    return _load_module("metrics", metric, bench_dir).read


def load_generator(name: str, bench_dir: Path = HERE):
    """The ``make(traffic, vocab, seed)`` of ``generators/<name>.py``,
    the generator a traffic mix names by its ``generator`` key."""
    return _load_module("generators", name, bench_dir).make
