#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size (``limits/<cell>.json`` records them).

    python3 port_bench/calibrate.py --workload <name> \\
        --program-seeds 1,2,... --control-seeds 7,8,9 [--seconds 2]

- The lower reading: the port's numbers over the program seeds, each a
  full run of the cell with a short window (``--seconds``).
- The upper reading: the control, the reference put in the port's place
  in the nearest precision below the configuration's (float8 products
  for a bfloat16 configuration), judged by the float32 reference on the
  control seeds.  Training also reads the fault of a batch half left
  out (the reference on the first half of each batch's rows); a state
  left unchanged reads 1 by the change's measure and needs no run.
  Serving reads the control at every position of the served sequences:
  the gap of the token the control puts first.

Prints one JSON line per reading.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _seeds(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def control_train(cell, seed: int, device) -> dict:
    """The fp8 control's and the half-batch fault's numbers against the
    fp32 reference, at the cell's size."""
    import torch

    from port_bench import check, spec
    from port_bench.drivers.train import reference_train
    from port_bench.model import dims
    from port_bench.reference.model import Precision

    d = dims(cell.config, "train")
    sec = cell.config["train"]
    batches = spec.load_generator(cell.traffic["generator"])(
        cell.traffic, d.vocab, seed)
    n = int(cell.traffic["checked_steps"])
    want = reference_train(d, seed, batches, sec, device, n)
    out = {}
    ctrl = reference_train(d, seed, batches, sec, device, n,
                           pr=Precision(fp8=True))
    out["control"] = check.train_numbers(ctrl, want)
    half = reference_train(d, seed, batches, sec, device, n,
                           rows_kept=batches.batch // 2)
    out["half_batch"] = check.train_numbers(half, want)
    del ctrl, half
    gc.collect()
    torch.cuda.empty_cache()
    return out


def control_serve(cell, judged: list, seed: int, device) -> dict:
    """The fp8 control's gap at every position of the served sequences,
    judged by the fp32 reference."""
    import torch

    from port_bench import check, weights
    from port_bench.model import dims
    from port_bench.reference import model as ref

    d = dims(cell.config, "serve")
    dtype = getattr(torch, cell.config["precision"]["compute"])
    ref.no_tf32()
    p = weights.make(d, seed, dtype, device)
    seqs = [(torch.as_tensor(pr + tk, device=device), len(tk))
            for pr, tk in judged]
    want = ref.served_logits(p, seqs, d)
    ctrl = ref.served_logits(p, seqs, d, ref.Precision(fp8=True))
    return {"control": {"served_gap": check.control_gap(want, ctrl)},
            "program_again": {"served_gap": check.served_gap(
                want, [tk for _, tk in judged])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import check, spec
    from port_bench.drivers import Run
    from port_bench.drivers import serve as serve_driver
    from port_bench.drivers import train as train_driver

    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    serving = cell.traffic["driver"] == "serve"
    driver = serve_driver if serving else train_driver
    control = set(_seeds(args.control_seeds))
    for seed in _seeds(args.program_seeds):
        t = time.monotonic()
        out = driver.run(Run(cell=cell, seed=seed, seconds=args.seconds,
                             trace=False, t_start=t, device=dev))
        line = {"seed": seed, "program": out.numbers,
                "attempted": out.attempted, "failed": out.failed}
        if not serving:
            prog, want = out.judged
            for what in ("grad", "change"):
                gaps = check.leaf_gaps(prog[what], want[what],
                                       sorted(want[what]))
                line[f"worst_{what}"] = sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:3]
        print(json.dumps(line), flush=True)
        if serving and seed in control:
            print(json.dumps({"seed": seed, **control_serve(
                cell, out.judged, seed, dev)}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    if not serving:
        for seed in sorted(control):
            print(json.dumps({"seed": seed, **control_train(cell, seed,
                                                             dev)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
