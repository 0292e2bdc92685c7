#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and how fast, for ranks
that share one card (NCCL refuses two ranks on one card, so the port's
multi-rank layouts run there over gloo).

    python3 scripts/gloo_cuda_probe.py      # two ranks on card 0

It prints one JSON object: for each collective on rank 0 (run twice:
the first call pays gloo's set-up), whether it accepted CUDA tensors
and gave the right answer, its wall milliseconds with the device
synchronized around it, or the error it raised, or that the process
died in it (gloo's send/recv of CUDA tensors can abort the process
from a transport thread, so they run last).  The payload is 16 MB
of bf16 (the compact K/V of a ring hop at Llama-3-8B widths, seq 4096 a
rank) and, for the large all-reduce, 1 GiB of fp32 (a slice of the seq
group's gradient all-reduce).  Needs a card; imports torch only.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

N = 8 * 2**20            # bf16 elements: 16 MB


def probes(rank: int, dev) -> dict:
    """name -> a function that runs one collective and checks it."""
    x = torch.full((N,), float(rank + 1), dtype=torch.bfloat16, device=dev)
    other = float(2 - rank)

    def a2a_to_neighbour():
        out = torch.empty_like(x)
        send, recv = [0, 0], [0, 0]
        send[(rank + 1) % 2] = recv[(rank - 1) % 2] = N
        dist.all_to_all_single(out, x, recv, send)
        return float(out[0]) == other

    def a2a_even():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return float(out[-1]) == other

    def all_gather_into_tensor():
        out = torch.empty(2 * N, dtype=x.dtype, device=dev)
        dist.all_gather_into_tensor(out, x)
        return float(out[-1]) == 2.0

    def all_gather_list():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return float(parts[1][0]) == 2.0

    def all_reduce_16mb():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0]) == 3.0

    def all_reduce_1gib_fp32():
        y = torch.ones(256 * 2**20, device=dev)
        dist.all_reduce(y)
        return float(y[0]) == 2.0

    def send_recv():
        out = torch.empty_like(x)
        if rank == 0:
            dist.send(x, 1)
            dist.recv(out, 1)
        else:
            dist.recv(out, 0)
            dist.send(x, 0)
        return float(out[0]) == other

    return {f.__name__: f for f in (
        a2a_to_neighbour, a2a_even, all_gather_into_tensor, all_gather_list,
        all_reduce_16mb, all_reduce_1gib_fp32, send_recv)}


def rank_main(rank: int, init: str) -> None:
    """Run every probe; rank 0 prints a JSON line as each starts and as
    it ends, so its parent can name the probe a crash happened in."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    for name, fn in probes(rank, dev).items():
        for call in ("first", "again"):
            key = f"{name} ({call})"
            if rank == 0:
                print(json.dumps({"start": key}), flush=True)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ok = fn()
                torch.cuda.synchronize()
                res = {"ok": bool(ok), "ms": (time.perf_counter() - t0) * 1e3}
            except RuntimeError as e:
                res = {"ok": False, "error": str(e)[:300]}
            if rank == 0:
                print(json.dumps({"end": key, "result": res}), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, __file__, str(r), init],
                              stdout=subprocess.PIPE if r == 0 else None,
                              text=True)
             for r in range(2)]
    try:
        out, _ = procs[0].communicate(timeout=300)
    except subprocess.TimeoutExpired:        # its peer died mid-probe
        procs[0].kill()
        out, _ = procs[0].communicate()
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=30))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    results, running = {}, None
    for line in out.splitlines():
        rec = json.loads(line)
        if "start" in rec:
            running = rec["start"]
        else:
            results[rec["end"]] = rec["result"]
            running = None
    if running is not None:
        results[running] = {"ok": False, "error": f"the ranks died in it "
                            f"(exit codes {rcs})"}
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0),
                      "probes": results}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
