#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``theanompi_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases:

1. card and build — the card's name and power limit from nvidia-smi;
   every kernel built from ``theanompi_tpu_torch/csrc`` (one nvcc per
   source, all at once), with the build time;
2. kernels — each kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, with its error,
   tolerance and times (kernel, plain version, and the one PyTorch
   call computing the same function, where there is one); then a small
   fp32 model served on the card and on the CPU, greedy ids compared;
3. v1 serving — a Llama at Llama-3-8B width (random weights from a
   seed, bf16) under ``LlamaDecoder`` and ``Engine``: 12 greedy
   requests batched, 3 of them again alone, ids compared; kernel K1's
   launches counted over the batched run; a decode-only profile;
4. paged serving — the same model under ``PagedLlamaDecoder`` with
   chunked prefill, the same requests plus 4 sharing a system prompt:
   prefix-cache hits, batched == alone, K4's launches counted; a
   decode-only profile;
5. the kernels line — one JSON object with every kernel's numbers.

The last line of standard output is ``{"ok": true, "device": ...}``.
Any failure raises and the exit code is not 0.  Without a CUDA device,
or without the package beside this file, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): bytes/s and ops/s by dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# (atol, rtol) of a kernel against its plain version evaluated in fp32
# on the same inputs: fp32 differs by summation order only; bf16 adds
# the rounding of the output to bf16 (half an ulp: 2**-9 relative)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}

REDUCED = {
    "max_seq": "2048 (LLAMA3_8B.seq_len 8192): the run's time limit",
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(got, ref, dtype_name: str) -> tuple[float, bool]:
    """(max |got - ref|, whether every element is within
    atol + rtol * |ref|) under ``TOL[dtype_name]``."""
    atol, rtol = TOL[dtype_name]
    diff = (got.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return diff.max().item(), ok


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` launches,
    each timed alone with CUDA events after ``warmup`` calls; ``flush``
    (a large tensor) is overwritten before every launch so each one
    finds the L2 cache cold, as a layer's call on the serving path
    does."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 2: kernels against their plain versions -------------------------

def check_flash(dev, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops.attention import (
        flash_fwd_cuda,
        mha_reference,
        mha_reference_fwd,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    h, hd = 32, 128
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for t in (16, 512, 2047):
            q, k, v = (
                torch.randn((1, h, t, hd), generator=gen, device=dev)
                .to(dtype) for _ in range(3)
            )
            o, lse = flash_fwd_cuda(q, k, v, True, hd ** -0.5)
            o_ref, lse_ref = mha_reference_fwd(
                q.float(), k.float(), v.float(), causal=True
            )
            torch.cuda.synchronize()
            err, ok_o = compare(o, o_ref, name)
            lerr, ok_l = compare(lse, lse_ref, "float32")
            ok = ok_o and ok_l
            log(f"K1 flash_fwd {name} [1,{h},{t},{hd}] causal: "
                f"max_abs_err o {err:.3e} (atol, rtol {TOL[name]}), lse "
                f"{lerr:.3e} (atol, rtol {TOL['float32']}) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 disagrees with mha_reference "
                                     f"at {name} T={t}")
            if dtype is torch.bfloat16 and t == 2047:
                ms = time_ms(lambda: flash_fwd_cuda(q, k, v, True,
                                                    hd ** -0.5),
                             flush=flush)
                plain = time_ms(lambda: mha_reference(q, k, v,
                                                      causal=True),
                                flush=flush)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), flush=flush)
                ops = 4 * hd * h * t * (t + 1) / 2
                nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
                t_ops = ops / PEAK_OPS[name] * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                record = {
                    "name": "flash_fwd", "route": "cuda",
                    "source": "theanompi_tpu_torch/csrc/flash_fwd.cu",
                    "replaces": "theanompi_tpu/ops/attention.py:146",
                    "shape": f"[1,{h},{t},{hd}] {name} causal",
                    "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes
                    else "bytes",
                    "library_ms": lib,
                }
                log(f"K1 times bf16 T={t}: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound "
                    f"{record['bound_ms']:.4f} ms ({record['bound_by']})")
    return record


def paged_case(dev, dtype, gen, *, s=8, hkv=8, rep=4, hd=128, bs=16,
               mb=128):
    """Decode-shaped K4 inputs: ragged positions, each slot owning
    distinct random blocks for its positions, the rest of its table
    trash-padded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    n_blocks = s * mb
    pos = rng.integers(0, mb * bs, size=(s, 1)).astype(np.int32)
    perm = rng.permutation(n_blocks)
    tables = np.full((s, mb), n_blocks, np.int32)     # trash id
    used = 0
    for i in range(s):
        n = int(pos[i, 0]) // bs + 1
        tables[i, :n] = perm[used:used + n]
        used += n
    kp = torch.randn((n_blocks + 1, hkv, bs, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_blocks + 1, hkv, bs, hd), generator=gen,
                     device=dev).to(dtype)
    q = torch.randn((s, 1, hkv, rep, hd), generator=gen,
                    device=dev).to(dtype)
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(pos, device=dev))


def check_paged(dev, flush) -> dict:
    import torch

    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
        paged_attend_reference,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, kp, vp, tables, pos = paged_case(dev, dtype, gen)
        out = paged_attend_cuda(q, kp, vp, tables, pos)
        ref = paged_attend_reference(q.float(), kp.float(), vp.float(),
                                     tables, pos)
        torch.cuda.synchronize()
        err, ok = compare(out, ref, name)
        log(f"K4 paged_attend {name} S=8 Q=1 Hkv=8 rep=4 hd=128 bs=16 "
            f"MB=128: max_abs_err {err:.3e} (atol, rtol {TOL[name]}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K4 disagrees with the gather path "
                                 f"at {name}")
        if dtype is torch.bfloat16:
            ms = time_ms(lambda: paged_attend_cuda(q, kp, vp, tables, pos),
                         flush=flush)
            plain = time_ms(lambda: paged_attend_reference(
                q, kp, vp, tables, pos), flush=flush)
            s, nq, hkv, rep, hd = q.shape
            bs = kp.shape[2]
            walked = sum(
                (int(p) // bs + 1) * bs for p in pos.max(dim=1).values
            )
            isz = q.element_size()
            nbytes = (2 * walked * hkv * hd * isz + 2 * q.numel() * isz
                      + tables.numel() * 4 + pos.numel() * 4)
            ops = 4 * walked * hkv * rep * nq * hd
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[name] * 1e3
            record = {
                "name": "paged_attend", "route": "cuda",
                "source": "theanompi_tpu_torch/csrc/paged_attend.cu",
                "replaces": "theanompi_tpu/serving/paged_attention.py:67",
                "shape": "S=8 Q=1 Hkv=8 rep=4 hd=128 bs=16 MB=128 bf16",
                "launches": None, "max_abs_err": err, "ms": ms,
                "plain_ms": plain,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            }
            log(f"K4 times bf16: kernel {ms:.4f} ms, plain {plain:.4f} "
                f"ms, bound {record['bound_ms']:.4f} ms "
                f"({record['bound_by']}, {walked} walked positions)")
    return record


# -- serving -----------------------------------------------------------------

SMALL = dict(dim=256, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=512,
             vocab=512, seq_len=256, compute_dtype="float32", seed=5)


def serve(dec, prompts, *, max_tokens, seeds, prefix_caching=True):
    """Submit every prompt to one engine over ``dec``, run it until
    idle, and return (token lists, recorder summary, paging stats,
    wall seconds).  Raises unless every request resolved ``ok`` with
    ``max_tokens`` tokens."""
    import torch

    from theanompi_tpu_torch.serving import Engine

    eng = Engine(dec, prefix_caching=prefix_caching)
    futs = [eng.submit(p, max_tokens=max_tokens, seed=s)
            for p, s in zip(prompts, seeds)]
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = []
    for i, f in enumerate(futs):
        if not f.done():
            raise AssertionError(f"request {i} never resolved")
        r = f.result(timeout=0)
        if r.status != "ok" or len(r.tokens) != max_tokens:
            raise AssertionError(
                f"request {i}: {r.status}/{r.finish_reason}, "
                f"{len(r.tokens)} tokens"
            )
        if not all(0 <= t < dec.model.vocab for t in r.tokens):
            raise AssertionError(f"request {i}: token id out of range")
        out.append(r.tokens)
    return out, eng.recorder.summary(), eng.paging_stats(), wall


def check_reference(dev) -> None:
    """A small fp32 model served on the card (through both kernels) and
    on the CPU (through their plain versions), same weights and
    prompts: the greedy ids must agree."""
    import numpy as np

    from theanompi_tpu_torch.models import Llama

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, SMALL["vocab"], size=n).tolist()
               for n in (5, 17, 40, 100)]
    gpu = Llama(SMALL, device=dev)
    cpu_params = {
        "embed": gpu.params["embed"].cpu(),
        "layers": [{k: t.cpu() for k, t in lp.items()}
                   for lp in gpu.params["layers"]],
        "final_norm": gpu.params["final_norm"].cpu(),
        "lm_head": gpu.params["lm_head"].cpu(),
    }
    cpu = Llama(SMALL, device="cpu", params=cpu_params)
    for paged in (False, True):
        kw = dict(max_slots=4, max_seq=128)
        if paged:
            kw.update(block_size=16, prefill_chunk=32)
        ids = [serve(m.make_decoder(paged=paged, **kw), prompts,
                     max_tokens=12, seeds=range(4))[0] for m in (gpu, cpu)]
        name = "paged" if paged else "v1"
        same = ids[0] == ids[1]
        log(f"reference [{name}] small fp32 model, card vs CPU greedy "
            f"ids: {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name}: card and CPU ids differ: {ids}")


def make_requests(vocab: int):
    """12 prompts of 16-1500 tokens, then 4 sharing a 256-token system
    prompt (the paged phase's prefix-cache traffic), from a seed."""
    import numpy as np

    rng = np.random.default_rng(3)
    lengths = rng.integers(16, 1501, size=12)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist()
               for n in lengths]
    system = rng.integers(0, vocab, size=256).tolist()
    shared = [system + rng.integers(0, vocab, size=int(n)).tolist()
              for n in rng.integers(16, 200, size=4)]
    return prompts, shared


def run_serving(name, dec, prompts, alone_idx, counter) -> dict:
    """Drive one decoder through the engine: every prompt batched with
    ``counter`` (a kernel wrapper) reset just before and read just
    after, then a few prompts again alone; ids must agree."""
    card = card_line()
    seeds = list(range(len(prompts)))
    counter.launches = 0
    ids, summ, stats, wall = serve(dec, prompts, max_tokens=32, seeds=seeds)
    launches = counter.launches
    log(f"[{name}] {len(prompts)} requests batched in {wall:.2f} s; "
        f"{counter.__name__} launches {launches}")
    if launches <= 0:
        raise AssertionError(f"{name}: {counter.__name__} never launched")
    alone = [serve(dec, [prompts[i]], max_tokens=32, seeds=[seeds[i]],
                   prefix_caching=False)[0][0] for i in alone_idx]
    same = all(a == ids[i] for a, i in zip(alone, alone_idx))
    log(f"[{name}] requests {list(alone_idx)} alone vs batched ids: "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: batched ids differ from alone ids")
    keys = ("n_completed", "ttft_p50_s", "ttft_p95_s", "tpot_p50_s",
            "tpot_p95_s", "tokens_per_sec", "slot_occupancy",
            "prefix_hit_tokens", "prefix_hit_rate")
    log(f"[{name}] {json.dumps({k: summ[k] for k in keys})} on {card}")
    if stats is not None:
        log(f"[{name}] paging {json.dumps(stats)}")
    return {"launches": launches, "summary": summ, "stats": stats,
            "wall_s": wall}


def profile_decode(name, dec, prompts, steps: int = 8) -> dict:
    """Where a decode step's time goes: fill every slot, run engine
    steps until no slot is prefilling, then trace ``steps`` decode-only
    steps with ``torch.profiler``.  Reports wall ms per step, device
    kernel ms per step (busy share = kernel / wall) and the kernels
    with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from theanompi_tpu_torch.serving import Engine

    eng = Engine(dec, prefix_caching=False)
    for i, p in enumerate(prompts[:dec.max_slots]):
        eng.submit(p[:1024], max_tokens=dec.max_seq, seed=i)
    eng.step()
    while eng.n_prefilling():
        eng.step()

    def timed_steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall_ms = timed_steps()          # the profiler's own cost excluded
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_steps()
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    kernels.sort(key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in kernels)
    out = {
        "decoder": name, "steps": steps, "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_ms,
        "device_ms_per_step": dev_ms,
        "busy_share": dev_ms / wall_ms if wall_ms else None,
        "top_kernels_ms_per_step": {k[:80]: ms for k, ms in kernels[:6]},
    }
    log(f"[{name}] decode profile {json.dumps(out)} on {card_line()}")
    return out


# -- main -------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "theanompi_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: theanompi_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from theanompi_tpu_torch.kernels import _build
    from theanompi_tpu_torch.models import LLAMA3_8B, Llama
    from theanompi_tpu_torch.ops.attention import flash_fwd_cuda
    from theanompi_tpu_torch.serving import LlamaDecoder, PagedLlamaDecoder
    from theanompi_tpu_torch.serving.paged_attention import (
        paged_attend_cuda,
    )

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log("reduced: " + json.dumps(REDUCED))

    # phase 1: build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {len(reports)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", rep)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", rep))
        log(f"  {name}: {len(regs)} kernels, at most {max(regs)} "
            f"registers, {spills} bytes spilled")

    # phase 2: kernels against their plain versions
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    flash = check_flash(dev, flush)
    paged_rec = check_paged(dev, flush)
    del flush
    check_reference(dev)

    # phases 3-4: the serving paths at Llama-3-8B width
    cfg = dict(LLAMA3_8B, compute_dtype="bfloat16", seed=0)
    t0 = time.perf_counter()
    model = Llama(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"model: Llama {cfg} with {model.n_params() / 1e9:.3f} B params, "
        f"random init in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    prompts, shared = make_requests(model.vocab)
    warm = [prompts[0][:16]]

    dec = LlamaDecoder(model, max_slots=8, max_seq=2048)
    log(f"[v1] cache {dec.kv_cache_bytes() / 2**30:.2f} GiB")
    serve(dec, warm, max_tokens=2, seeds=[0])              # warm-up
    flash["launches"] = run_serving("v1", dec, prompts, (0, 5, 11),
                                    flash_fwd_cuda)["launches"]
    profile_decode("v1", dec, prompts)
    del dec

    dec = PagedLlamaDecoder(model, max_slots=8, max_seq=2048,
                            block_size=16, prefill_chunk=64)
    log(f"[paged] pools {dec.kv_cache_bytes() / 2**30:.2f} GiB")
    serve(dec, warm, max_tokens=2, seeds=[0], prefix_caching=False)
    # the first system-prompt request prefills (cold) ahead of the
    # queue; the other three queue behind the 12, so they arrive after
    # its blocks are cached and adopt them
    run = run_serving("paged", dec, shared[:1] + prompts + shared[1:],
                      (0, 1, 13, 15), paged_attend_cuda)
    paged_rec["launches"] = run["launches"]
    hits = run["stats"]["prefix_cache"]["n_hits"]
    log(f"[paged] prefix-cache hits {hits}")
    if hits < 1:
        raise AssertionError("paged: no prefix-cache hit")
    profile_decode("paged", dec, prompts)
    del dec
    log(f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # phase 5: the kernels line, the card, the result
    log(json.dumps({"kernels": [flash, paged_rec]}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
