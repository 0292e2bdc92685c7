"""Attention: the plain reference and the flash-attention forward (K1).

Port of ``theanompi_tpu/ops/attention.py``.  Shapes follow
[B, H, T, D] as in the JAX package.

- ``mha_reference`` — dense softmax attention with an f32 softmax: the
  numerical ground truth and the plain version of kernel K1.
- ``flash_attention_fwd`` — returns ``(o, lse)``: o [B, H, T, D] in the
  input dtype and the per-row logsumexp [B, H, T] in f32 (the residual
  the ring-attention merge and the backward kernels consume).
- ``flash_attention`` — the output alone.

Dispatch is by device: a CPU tensor gets the plain math, a CUDA tensor
always gets the hand-written kernel ``csrc/flash_fwd.cu`` (or an
error).  The kernel masks the ragged edge of T itself, so unlike the
TPU dispatch (whose block-divisibility rule sent ragged lengths to the
dense path) every length runs through it.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30  # finite "-inf": keeps exp() NaN-free in masked blocks

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLASH_HEAD_DIMS = (16, 32, 64, 128)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[Tq, Tk] bool — query may attend to keys at <= its position."""
    return q_pos[:, None] >= k_pos[None, :]


def _scores(q, k, causal, q_offset, k_offset, sm_scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[2], device=q.device)
        s = torch.where(causal_mask(q_pos, k_pos), s, NEG_INF)
    return s


def mha_reference(q, k, v, *, causal=True, q_offset=0, k_offset=0,
                  sm_scale=None):
    """Dense softmax attention, f32 softmax.  q,k,v: [B, H, T, D].

    ``q_offset``/``k_offset`` are the global positions of element 0,
    so sharded callers can mask correctly on local blocks."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, causal, q_offset, k_offset, sm_scale)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def mha_reference_fwd(q, k, v, *, causal=True, sm_scale=None):
    """``mha_reference`` plus the per-row logsumexp [B, H, T] f32 — the
    plain version of ``flash_attention_fwd``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, causal, 0, 0, sm_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o, torch.logsumexp(s, dim=-1)


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors
    q [B, H, Tq, D], k/v [B, H, Tk, D] (f32 or bf16).  Returns
    (o [B, H, Tq, D], lse [B, H, Tq] f32).  ``flash_fwd_cuda.launches``
    counts its launches."""
    from theanompi_tpu_torch.kernels import _build

    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd_cuda needs CUDA tensors, got {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"flash_fwd_cuda takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"flash_fwd_cuda shapes: q [B,H,Tq,D], k=v [B,H,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(
            f"flash_fwd_cuda supports head dims {FLASH_HEAD_DIMS}, got {d}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda needs contiguous q, k, v")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_fwd_cuda: q, k, v on different devices")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tm_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, float(sm_scale),
            int(bool(causal)), KERNEL_DTYPES[q.dtype], stream,
        )
    _build.check(lib, err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _flash_lib():
    from theanompi_tpu_torch.kernels import _build

    lib = _build.load("flash_fwd")
    fn = lib.tm_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = i
    return lib


def flash_attention_fwd(q, k, v, *, causal=True, sm_scale=None):
    """(o [B, H, T, D], lse [B, H, T] f32).  CPU tensors take the plain
    math; CUDA tensors launch kernel K1."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return mha_reference_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return flash_fwd_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, sm_scale
    )


def flash_attention(q, k, v, *, causal=True, sm_scale=None):
    """Attention output [B, H, T, D]; see ``flash_attention_fwd``."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
