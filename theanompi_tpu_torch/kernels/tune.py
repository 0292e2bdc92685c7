"""Time variants of the hand-written kernels' tile constants on a card.

    python3 -m theanompi_tpu_torch.kernels.tune fwd fwd:kTcBK=32 \\
        bwd bwd:kDqBK=32 paged paged:kSplit=128,kStages=2

Each argument names a source (``fwd``: K1 in ``csrc/flash_fwd.cu``,
``bwd``: K2 and K3 in ``csrc/flash_bwd.cu``, ``paged``: K4 in
``csrc/paged_attend.cu``) and, after a colon, comma-joined
``NAME=VALUE`` substitutions of its ``constexpr int NAME = ...;``
lines; a bare name is the source as it stands.  Every variant is
compiled as ``_build`` compiles (all at once, into
``build/theanompi_tpu_torch/tune/``), and its ptxas registers and
spills of the tensor-core kernels at D = 128 (bf16, and the fp32 K1,
K2 and K3 in three TF32 passes) are printed.  fwd and bwd variants:
bf16 results checked against the plain version in fp32 at six shapes
(worst error as a fraction of atol = rtol = 1e-2; bitwise across two
runs), each kernel timed (median of 20 launches, cold L2, CUDA events)
at the training shape [2, 32, 2048, 128] and the serving shape [1, 32,
2047, 128], causal, in two passes (in order, then reversed), SDPA's
forward and backward at the training shape last as the yardstick.
Both also run their fp32 route: checked at the same six shapes (atol =
rtol = 1e-4, bitwise across two runs) and timed at [1, 32, 2047, 128]
causal in the same two passes, beside SDPA's fp32 forward and backward
there.  paged variants: both dtypes checked
against the gather path (tolerance 1e-4 fp32, 1e-2 bf16; bitwise
across two runs) at the decode shape (S=8, Q=1, Hkv=8, rep=4, hd=128,
bs=16, MB=128), the 16-row verify shape (Q=4) and 32 rows (Q=8), and
timed the same way: bf16 at the first two, fp32 (three TF32 passes;
``kXWarps`` warps of ``kXPos`` positions a tile, ``kXStages`` tiles in
the ring, S summed in ``kXAcc`` accumulators) at all three.  Needs a
CUDA card.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys

from theanompi_tpu_torch.kernels import _build

SOURCES = {"fwd": "flash_fwd", "bwd": "flash_bwd", "paged": "paged_attend"}
SHAPES = (((2, 32, 2048, 128), True), ((1, 32, 2047, 128), True),
          ((1, 3, 129, 128), True), ((1, 3, 65, 64), False),
          ((1, 3, 15, 16), True), ((1, 3, 333, 32), False))


def parse(arg: str) -> tuple[str, str, dict]:
    kind, _, subs = arg.partition(":")
    if kind not in SOURCES:
        raise SystemExit(f"unknown source {kind!r}: one of {list(SOURCES)}")
    pairs = dict(s.split("=") for s in subs.split(",") if s)
    return arg, kind, {k: int(v) for k, v in pairs.items()}


def build_variants(variants) -> dict:
    """Compile every variant at once; print its D = 128 ptxas line;
    return the loaded libraries by variant name."""
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, kind, subs) in enumerate(variants):
        text = (_build.CSRC / f"{SOURCES[kind]}.cu").read_text()
        for key, val in subs.items():
            text, n = re.subn(rf"constexpr int {key} = \d+;",
                              f"constexpr int {key} = {val};", text)
            if n != 1:
                raise SystemExit(f"{name}: no single constexpr {key}")
        src = out_dir / f"v{i}.cu"
        src.write_text(text)
        procs[name] = (out_dir / f"v{i}.so", subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out_dir / f"v{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        for blk in log.split("Compiling entry function '")[1:]:
            kernel = re.search(r"(\w+_(?:tc|tf32x3)_kernel)ILi128E",
                               blk.split("'", 1)[0])
            if kernel:
                regs = re.search(r"Used (\d+) registers", blk).group(1)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", blk).groups()
                print(f"{name}: {kernel.group(1)} D=128 {regs} registers, "
                      f"spill stores/loads {spill[0]}/{spill[1]} bytes",
                      flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn, flush, reps=20):
    """Median device ms of ``fn()`` over ``reps`` launches after 3
    warm-up calls, each alone with a cold L2 (``flush`` overwritten
    first, which also keeps the device busy while the host enqueues
    ``fn``, so the timed window holds device time only)."""
    import torch

    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def frac(got, ref, tol=1e-2):
    """Worst |got - ref| as a fraction of atol + rtol * |ref| (both
    ``tol``)."""
    return ((got.float() - ref).abs() / (tol + tol * ref.abs())).max().item()


def tune_flash(libs, kinds, dev, flush) -> None:
    """Check and time the fwd (K1) and bwd (K2 and K3) variants, bf16
    and fp32."""
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import attention as A

    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    bf16, f32 = torch.bfloat16, torch.float32

    def call(name, q, k, v, do, lse, delta, causal, fn_name=None):
        """The variant's kernel on [B, H, T, D] inputs of q's dtype:
        (o, lse) for K1, (dk, dv) for K2 (``tm_flash_bwd_dkv``), (dq,)
        for K3 (``tm_flash_bwd_dq``)."""
        b, h, t, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        if kinds[name] == "fwd":
            outs = (torch.empty_like(q),
                    torch.empty((b, h, t), device=dev))
            fn, ins = libs[name].tm_flash_fwd, (q, k, v)
        else:
            dq = fn_name == "tm_flash_bwd_dq"
            outs = ((torch.empty_like(q),) if dq else
                    (torch.empty_like(k), torch.empty_like(v)))
            fn, ins = (getattr(libs[name], fn_name),
                       (q, k, v, do, lse, delta))
        ptrs = [x.data_ptr() for x in (*ins, *outs)]
        fn.argtypes = [p_] * len(ptrs) + [i_] * 4 + [f_, i_, i_, p_]
        err = fn(*ptrs, b * h, t, k.shape[2], d, d ** -0.5, int(causal),
                 A.KERNEL_DTYPES[q.dtype], stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return outs

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {bf16: [], f32: []}
    for dtype in cases:
        for shape, causal in SHAPES:
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                           .to(dtype) for _ in range(4))
            o, lse = A.mha_reference_fwd(q.float(), k.float(), v.float(),
                                         causal=causal)
            delta = (do.float() * o).sum(-1)
            ref = A.flash_bwd_reference(q.float(), k.float(), v.float(),
                                        do.float(), lse, delta,
                                        causal=causal)
            cases[dtype].append(((q, k, v, do, lse, delta, causal),
                                 (o, lse), ref))
    # (variant, entry point, dtype): K2 and K3 of a bwd variant are timed
    # apart; every kernel in both dtypes
    runs = [(name, fn, dtype) for name in libs
            for fn, dtype in (((None, bf16), (None, f32))
                              if kinds[name] == "fwd" else
                              (("tm_flash_bwd_dkv", bf16),
                               ("tm_flash_bwd_dq", bf16),
                               ("tm_flash_bwd_dkv", f32),
                               ("tm_flash_bwd_dq", f32)))]
    for name, fn, dtype in runs:
        worst, err, tol = 0.0, 0.0, 1e-2 if dtype is bf16 else 1e-4
        for args, (o, lse), (dq, dk, dv) in cases[dtype]:
            got = call(name, *args, fn_name=fn)
            again = call(name, *args, fn_name=fn)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} {fn} {dtype}: two runs "
                                     f"differ")
            if kinds[name] == "fwd":
                worst = max(worst, frac(got[0], o, tol),
                            (got[1] - lse).abs().max().item() / 1e-4)
                want = (o, lse)
            else:
                want = (dq,) if fn == "tm_flash_bwd_dq" else (dk, dv)
                worst = max([worst] + [frac(a, b, tol)
                                       for a, b in zip(got, want)])
            err = max([err] + [(a.float() - b).abs().max().item()
                               for a, b in zip(got, want)])
        print(f"{name} {fn or ''} {dtype}: worst error / tolerance "
              f"{worst:.3f} (atol = rtol = {tol}), max abs error "
              f"{err:.3e}", flush=True)
    # bf16 at the training and serving shapes, fp32 at the serving shape
    timed = {bf16: cases[bf16][:2], f32: cases[f32][1:2]}
    times = {run: [] for run in runs}
    for order in (runs, runs[::-1]):
        for name, fn, dtype in order:
            for args, _, _ in timed[dtype]:
                times[name, fn, dtype].append(time_ms(
                    lambda: call(name, *args, fn_name=fn), flush))
    for (name, fn, dtype), ts in times.items():
        if dtype is bf16:
            print(f"{name} {fn or ''} {dtype}: ms at the training shape "
                  f"{ts[0]:.4f}, {ts[2]:.4f}; at the serving shape "
                  f"{ts[1]:.4f}, {ts[3]:.4f} (passes 1, 2)")
        else:
            print(f"{name} {fn or ''} {dtype}: ms at the serving shape "
                  f"{ts[0]:.4f}, {ts[1]:.4f} (passes 1, 2)")
    for dtype, (args, _, _) in ((bf16, cases[bf16][0]),
                                (f32, cases[f32][1])):
        q, k, v, do = args[:4]
        fwd_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            flush)
        qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        bwd_ms = time_ms(lambda: torch.autograd.grad(o, (qq, kk, vv), do,
                                                     retain_graph=True),
                         flush)
        print(f"sdpa {dtype} {list(q.shape)}: forward {fwd_ms:.4f} ms, "
              f"backward (dq, dk, dv) {bwd_ms:.4f} ms")


def paged_inputs(dev, dtype, gen, nq, *, s=8, hkv=8, rep=4, hd=128, bs=16,
                 mb=128):
    """Serving-shaped K4 inputs: each slot's last position drawn in [0,
    mb*bs) from a seed, its nq query rows at the nq positions ending
    there, its table holding distinct blocks up to it and the trash id
    past it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    last = rng.integers(nq - 1, mb * bs, size=s)
    pos = np.stack([last - nq + 1 + j for j in range(nq)], 1)
    tables = np.full((s, mb), s * mb, np.int32)      # trash id
    perm, used = rng.permutation(s * mb), 0
    for i in range(s):
        n = int(last[i]) // bs + 1
        tables[i, :n] = perm[used:used + n]
        used += n

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return (rnd(s, nq, hkv, rep, hd), rnd(s * mb + 1, hkv, bs, hd),
            rnd(s * mb + 1, hkv, bs, hd),
            torch.as_tensor(tables, device=dev),
            torch.as_tensor(pos.astype(np.int32), device=dev))


def tune_paged(libs, dev, flush) -> None:
    """Check the paged (K4) variants in both dtypes against the gather
    path (bitwise across two runs too) at the decode shape (S=8, Q=1,
    Hkv=8, rep=4, hd=128, bs=16, MB=128), the 16-row verify shape (Q=4)
    and 32 rows (Q=8, two row groups), and time each dtype there: bf16
    at the decode and 16-row shapes, fp32 (three TF32 passes) at all
    three."""
    import torch

    from theanompi_tpu_torch.serving.paged_attention import (
        launch_with,
        paged_attend_reference,
    )

    def call(name, *args):
        return launch_with(libs[name], *args)

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {(dtype, nq): paged_inputs(dev, dtype, gen, nq)
             for dtype in (f32, bf16) for nq in (1, 4, 8)}
    for name in libs:
        worst = {f32: 0.0, bf16: 0.0}
        err = 0.0
        for (dtype, _), args in cases.items():
            ref = paged_attend_reference(*(a.float() if a.is_floating_point()
                                           else a for a in args))
            got = call(name, *args)
            if not torch.equal(got, call(name, *args)):
                raise AssertionError(f"{name}: two runs differ")
            tol = 1e-2 if dtype is bf16 else 1e-4
            worst[dtype] = max(worst[dtype], frac(got, ref, tol))
            if dtype is f32:
                err = max(err, (got - ref).abs().max().item())
        print(f"{name}: worst error / tolerance bf16 {worst[bf16]:.3f}, "
              f"fp32 {worst[f32]:.3f} (max abs error {err:.3e})",
              flush=True)
    timed = [(bf16, 1), (bf16, 4), (f32, 1), (f32, 4), (f32, 8)]
    times = {(name, at): [] for name in libs for at in timed}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for at in timed:
                args = cases[at]
                times[name, at].append(
                    time_ms(lambda: call(name, *args), flush))
    for name in libs:
        for dtype in (bf16, f32):
            print(f"{name}: {str(dtype).split('.')[1]} ms "
                  + "; ".join(f"{4 * nq} rows {ts[0]:.4f}, {ts[1]:.4f}"
                              for (n, (dt, nq)), ts in times.items()
                              if n == name and dt is dtype)
                  + " (passes 1, 2)", flush=True)


def main(argv=None) -> int:
    import torch

    variants = [parse(a) for a in (argv or sys.argv[1:])]
    if not variants or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    libs = build_variants(variants)
    kinds = {name: kind for name, kind, _ in variants}
    dev = torch.device("cuda", 0)
    # 1 GiB: overwriting it outlasts the host's enqueueing of a call
    flush = torch.empty(256 * 2**20, dtype=torch.int32, device=dev)
    flash = {n: lib for n, lib in libs.items() if kinds[n] != "paged"}
    paged = {n: lib for n, lib in libs.items() if kinds[n] == "paged"}
    if flash:
        tune_flash(flash, kinds, dev, flush)
    if paged:
        tune_paged(paged, dev, flush)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
