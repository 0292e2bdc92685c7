"""Time variants of the tensor-core kernels' tile constants on a card.

    python3 -m theanompi_tpu_torch.kernels.tune fwd fwd:kTcBK=32 \\
        fwd:kTcWarps=8 bwd bwd:kTcBQ=64

Each argument names a source (``fwd``: K1 in ``csrc/flash_fwd.cu``,
``bwd``: K2 in ``csrc/flash_bwd.cu``) and, after a colon, comma-joined
``NAME=VALUE`` substitutions of its ``constexpr int NAME = ...;``
lines; a bare name is the source as it stands.  Every variant is
compiled as ``_build`` compiles (all at once, into
``build/theanompi_tpu_torch/tune/``), its ptxas registers and spills at
D = 128 printed, its bf16 results checked against the plain version in
fp32 at six shapes (worst error as a fraction of atol = rtol = 1e-2;
K2 also bitwise across two runs), and it is timed (median of 20
launches, cold L2, CUDA events) at the training shape [2, 32, 2048,
128] and the serving shape [1, 32, 2047, 128], causal, in two passes
(in order, then reversed).  SDPA's forward and backward at the
training shape are timed last as the yardstick.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys

from theanompi_tpu_torch.kernels import _build

SOURCES = {"fwd": "flash_fwd", "bwd": "flash_bwd"}
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
            if "_tc_kernelILi128E" in blk.split("'", 1)[0]:
                regs = re.search(r"Used (\d+) registers", blk).group(1)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", blk).groups()
                print(f"{name}: D=128 {regs} registers, spill stores/loads "
                      f"{spill[0]}/{spill[1]} bytes", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from theanompi_tpu_torch.ops import attention as A

    variants = [parse(a) for a in (argv or sys.argv[1:])]
    if not variants or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    libs = build_variants(variants)
    kinds = {name: kind for name, kind, _ in variants}
    dev = torch.device("cuda", 0)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def call(name, q, k, v, do, lse, delta, causal):
        """The variant's kernel on bf16 [B, H, T, D] inputs: (o, lse)
        for K1, (dk, dv) for K2."""
        b, h, t, d = q.shape
        stream = torch.cuda.current_stream().cuda_stream
        if kinds[name] == "fwd":
            outs = (torch.empty_like(q),
                    torch.empty((b, h, t), device=dev))
            fn, ins = libs[name].tm_flash_fwd, (q, k, v)
        else:
            outs = (torch.empty_like(k), torch.empty_like(v))
            fn, ins = libs[name].tm_flash_bwd_dkv, (q, k, v, do, lse, delta)
        ptrs = [x.data_ptr() for x in (*ins, *outs)]
        fn.argtypes = [p_] * len(ptrs) + [i_] * 4 + [f_, i_, i_, p_]
        err = fn(*ptrs, b * h, t, k.shape[2], d, d ** -0.5, int(causal),
                 A.KERNEL_DTYPES[torch.bfloat16], stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return outs

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def time_ms(fn, reps=20):
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

    def frac(got, ref):
        return ((got.float() - ref).abs()
                / (1e-2 + 1e-2 * ref.abs())).max().item()

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape, causal in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = A.mha_reference_fwd(q.float(), k.float(), v.float(),
                                     causal=causal)
        delta = (do.float() * o).sum(-1)
        ref = A.flash_bwd_reference(q.float(), k.float(), v.float(),
                                    do.float(), lse, delta, causal=causal)
        cases.append(((q, k, v, do, lse, delta, causal), (o, lse),
                      ref[1:]))
    for name in libs:
        worst = 0.0
        for args, (o, lse), (dk, dv) in cases:
            got = call(name, *args)
            if kinds[name] == "fwd":
                worst = max(worst, frac(got[0], o),
                            (got[1] - lse).abs().max().item() / 1e-4)
            else:
                again = call(name, *args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name}: two runs differ")
                worst = max(worst, frac(got[0], dk), frac(got[1], dv))
        print(f"{name}: worst error / tolerance {worst:.3f}", flush=True)
    times = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for args, _, _ in cases[:2]:
                times[name].append(time_ms(lambda: call(name, *args)))
    for name, ts in times.items():
        print(f"{name}: ms at the training shape {ts[0]:.4f}, {ts[2]:.4f}"
              f"; at the serving shape {ts[1]:.4f}, {ts[3]:.4f} (passes 1, "
              f"2)")
    q, k, v, do = cases[0][0][:4]
    fwd_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(o, (qq, kk, vv), do,
                                                 retain_graph=True))
    print(f"sdpa at the training shape: forward {fwd_ms:.4f} ms, backward "
          f"(dq, dk, dv) {bwd_ms:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
