#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the comparison with the reference took, beside
its limit.  The same numbers end standard error.

Exits without a result when no card (or too few) is visible, and when,
once the window has closed, a module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``theanompi_tpu`` has been imported.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "theanompi_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the
    first dot) is one of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's nvcc libraries already live under ``build/``)."""
    cache = root / "build" / "port_bench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out, trace: bool, device_info: dict) -> dict:
    """The run's result in the contract's key order, ``checks`` last."""
    from port_bench import check, spec

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(out.records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    correct, checks = check.verdict(out.numbers, cell.limits)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=int(out.memory_peak_bytes))}
    if trace:
        line["device"].update(busy_s=out.busy_s, window_s=out.window_s)
        line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    from port_bench import spec
    from port_bench.drivers import Run

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    from port_bench import flops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    driver = importlib.import_module(
        f"port_bench.drivers.{cell.traffic['driver']}")
    out = driver.run(Run(cell=cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=T_START,
                         device=dev))
    line = result_line(cell, out, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": cell.chips, "power_limit": flops.power_limit()})
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of the JAX package or JAX: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
