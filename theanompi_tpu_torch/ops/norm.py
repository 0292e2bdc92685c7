"""RMS norm: the plain PyTorch expression and, for the serving decoder
on the card, a hand-written CUDA kernel whose result for a row depends
on that row alone (``csrc/rms_norm.cu``).

- :func:`rms_norm` — the model math of ``theanompi_tpu/models/llama.py``
  (fp32 mean of squares, ``rsqrt``, the product rounded to the input's
  dtype, then times the weight in that dtype).  Training uses it under
  autograd (the kernel has no backward), the CPU path uses it, and it
  is the kernel's plain version.
- :func:`rms_norm_cuda` — the kernel: one CTA a row, a fixed summation
  order, the same rounding.  PyTorch's mean on the card sums a row in
  an order that depends on how many rows the call has, so speculative
  verify (32 rows) and one-token decode (8 rows) rounded a row apart;
  the kernel makes every serving norm independent of the row count.
- :func:`rms_norm_rows` — what the serving decoder calls: the plain
  version for a CPU tensor, the kernel for a CUDA tensor (a failed
  build or launch raises; there is no fallback).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from theanompi_tpu_torch.ops.attention import KERNEL_DTYPES

_count_lock = threading.Lock()


def rms_norm(x, w, eps=1e-5):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w.to(x.dtype)


def _bind(lib):
    fn = lib.tm_rms_norm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, ctypes.c_float, i, p]
        fn.restype = i
    return lib


def rms_norm_cuda(x, w, eps=1e-5):
    """The kernel on a contiguous CUDA ``x`` [..., d] (fp32 or bf16,
    any d >= 1) and ``w`` [d] of the same dtype; launches on the
    current stream and counts the launch in ``rms_norm_cuda.launches``."""
    from theanompi_tpu_torch.kernels import _build

    d = x.shape[-1]
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("rms_norm_cuda takes x and w on one CUDA device")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rms_norm_cuda takes float32 or bfloat16 x and w "
                        f"of one dtype, got {x.dtype}/{w.dtype}")
    if tuple(w.shape) != (d,) or d < 1:
        raise ValueError(f"rms_norm_cuda: w must be [{d}] with d >= 1, "
                         f"got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm_cuda needs contiguous x and w")
    lib = _bind(_build.load("rms_norm"))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tm_rms_norm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              x.numel() // d, d, float(eps),
                              KERNEL_DTYPES[x.dtype], stream)
    _build.check(lib, err, "rms_norm")
    _count_launch()
    return out


def _count_launch() -> None:
    """Count one launch on ``rms_norm_cuda.launches``, under a lock: the
    fleet's replica threads launch the kernel at once."""
    with _count_lock:
        rms_norm_cuda.launches += 1


rms_norm_cuda.launches = 0


def rms_norm_rows(x, w, eps=1e-5):
    """The serving decoder's norm: :func:`rms_norm` on the CPU, the
    kernel on the card (w cast to x's dtype, as the plain version
    does)."""
    if x.device.type == "cpu":
        return rms_norm(x, w, eps)
    return rms_norm_cuda(x.contiguous(), w.to(x.dtype).contiguous(), eps)
