#!/usr/bin/env python3
"""Find a serving cell's knee once, on the card, at the cell's own
lengths: the open loop of the cell's mix at each of ``--rates``, for
each ``--slots``, in one process.

    python3 port_bench/sweep.py --workload <serving cell> --seed <n> \\
        --rates 1.5,2,2.5 --slots 64,32 [--seconds 20]

Each rate draws its requests from a seed of its own (``--seed`` plus
its place), so no rate finds another's prompts in the prefix cache.  A
rate is sustained when the requests due in its window completed (95%
of them within ``--drain`` seconds of the close; a long request due
late may take longer) and the queue did not grow: the median time to
first token of the window's last third is at most 1.5 times the first
third's plus 0.3 s.  The sweep stops at the first rate not sustained.
Each reading is one JSON line; live KV blocks are the distinct
blocks in the tables of the decode calls (the driver's probe).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _floats(s: str) -> list:
    return [float(x) for x in s.split(",") if x]


def one_rate(eng, probe, mix: dict, vocab: int, seed: int, warm: float,
             seconds: float, drain: float) -> dict:
    from port_bench import spec
    from port_bench.drivers.serve import Arrivals, _ok, tails
    from port_bench.drivers.serve import percentile as pct

    arrivals = Arrivals(eng, spec.load_generator(mix["generator"])(
        mix, vocab, seed), time.monotonic())
    t_warm = time.monotonic() + warm
    while time.monotonic() < t_warm:
        arrivals.step()
    probe.live_blocks_peak = probe.live_slots_peak = 0
    probe.in_window = True
    t0 = time.monotonic()
    n_steps = 0
    while time.monotonic() < t0 + seconds:
        arrivals.step()
        n_steps += 1
    t1 = time.monotonic()
    probe.in_window = False
    window = [e for e in arrivals.log if t0 <= e["t_due"] < t1]
    deadline = t1 + drain
    while any("result" not in e for e in window) and \
            time.monotonic() < deadline:
        arrivals.step()
    drained = all("result" in e for e in window)
    t_end = time.monotonic()
    eng.abandon_all("sweep_end")
    while eng.step():
        pass
    for e in window:
        if "result" not in e:
            e["result"] = None
    ttft, tpot = tails(window, t_end)
    third = max(1, len(window) // 3)
    first = statistics.median(ttft[:third])
    last = statistics.median(ttft[-third:])
    ok = sum(1 for e in window if _ok(e))
    return {
        "rate": mix["rate_per_s"], "window_s": t1 - t0,
        "due": len(window), "ok": ok,
        "ok_per_s": ok / (t1 - t0), "drained": drained,
        "ttft_p50_ms": 1e3 * pct(ttft, 0.5),
        "ttft_p90_ms": 1e3 * pct(ttft, 0.9),
        "ttft_p95_ms": 1e3 * pct(ttft, 0.95),
        "tpot_p50_ms": 1e3 * pct(tpot, 0.5),
        "tpot_p90_ms": 1e3 * pct(tpot, 0.9),
        "tpot_p95_ms": 1e3 * pct(tpot, 0.95),
        "ttft_first_third_ms": 1e3 * first, "ttft_last_third_ms": 1e3 * last,
        "steps": n_steps, "step_ms": 1e3 * (t1 - t0) / max(1, n_steps),
        "live_blocks_peak": probe.live_blocks_peak,
        "live_slots_peak": probe.live_slots_peak,
        "sustained": bool(ok >= 0.95 * len(window)
                          and last <= 1.5 * first + 0.3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--slots", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warm", type=float, default=5.0)
    ap.add_argument("--drain", type=float, default=60.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import spec
    from port_bench.drivers.serve import Probe, build
    from theanompi_tpu_torch.serving import decoder as decoder_module

    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    slots = [int(x) for x in _floats(args.slots)] or \
        [int(cell.config["serve"]["max_slots"])]
    best = (0.0, None)
    for n_slots in slots:
        dec, eng, d, sv = build(cell, args.seed, dev, False,
                                {"max_slots": n_slots})
        probe = Probe(dec, decoder_module, d, int(sv["n_blocks"]))
        for i, rate in enumerate(_floats(args.rates)):
            # a seed of its own a rate: the prompts of one rate would be
            # the prefix cache's hits at the next
            mix = dict(cell.traffic, rate_per_s=rate)
            got = one_rate(eng, probe, mix, d.vocab, args.seed + i,
                           args.warm, args.seconds, args.drain)
            print(json.dumps({"slots": n_slots, **got}), flush=True)
            if not got["sustained"]:
                break
            if rate > best[0]:
                best = (rate, n_slots)
        probe.remove()
        del probe, eng, dec
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"knee": best[0], "slots": best[1],
                      "peak_bytes": torch.cuda.max_memory_allocated(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
