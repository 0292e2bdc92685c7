"""Attention: the plain reference, the flash-attention forward (K1)
and its backward (K2, K3).

Port of ``theanompi_tpu/ops/attention.py``.  Shapes follow
[B, H, T, D] as in the JAX package.

- ``mha_reference`` — dense softmax attention with an f32 softmax: the
  numerical ground truth and the plain version of kernel K1.
- ``block_attn_update`` / ``block_attn_init`` / ``block_attn_finish`` —
  one step of the online-softmax recurrence over a KV block and its
  carry (the JAX functions of the same names): ring attention's dense
  route, and the plain version of its per-hop merge.
- ``flash_attention_fwd`` — returns ``(o, lse)``: o [B, H, T, D] in the
  input dtype and the per-row logsumexp [B, H, T] in f32 (the residual
  the ring-attention merge and the backward kernels consume).
- ``flash_bwd`` — ``(dq, dk, dv)`` against EXPLICIT residuals
  ``(lse, delta)`` [B, H, T] f32, as ``_flash_bwd_call`` takes them, so
  ring attention can pass global ones; ``flash_bwd_reference`` is its
  plain version (the explicit formulas, not autograd).
- ``flash_attention`` — the output alone, differentiable: the
  ``FlashAttention`` autograd function runs K1 forward and K2/K3
  backward (``delta = rowsum(dO*O)`` in f32, computed outside the
  kernels as in ``_flash_bwd``).

Dispatch is by device: a CPU tensor gets the plain math, a CUDA tensor
always gets the hand-written kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` (or an error).  On the card the dtype picks the
kernel, one per dtype: bf16 runs K1, K2 and K3 on the tensor cores,
fp32 on the SIMT kernels.  The kernels mask the
ragged edge of T themselves, so unlike the TPU dispatch (whose
block-divisibility rule sent ragged lengths to the dense path) every
length runs through them.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

NEG_INF = -1e30  # finite "-inf": keeps exp() NaN-free in masked blocks

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the dtype csrc/ sends to the tensor-core kernels of K1, K2 and K3
TC_DTYPE = torch.bfloat16
FLASH_HEAD_DIMS = (16, 32, 64, 128)


def _check_tc_aligned(name, *ts):
    """The tensor-core kernels copy rows 16 bytes at a time."""
    if ts[0].dtype == TC_DTYPE and any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} needs 16-byte aligned bf16 inputs")


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


def block_attn_update(carry, q, k_blk, v_blk, *, q_pos, k_pos,
                      sm_scale: float):
    """Fold one KV block into the online-softmax carry ``(acc [B,H,Tq,D]
    f32, m [B,H,Tq] f32 running max, l [B,H,Tq] f32 running sum)``.
    ``q_pos``/``k_pos`` (global positions) mask causally; None for full
    attention.  A fully masked block contributes exact zeros."""
    acc, m, l = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, k_blk).float() * sm_scale
    mask = None
    if q_pos is not None:
        mask = causal_mask(q_pos, k_pos)
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(v_blk.dtype), v_blk).float()
    return acc_new, m_new, l_new


def block_attn_init(b, h, tq, d, device=None):
    """A fresh online-softmax carry."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, h, tq, d), **f32),
            torch.full((b, h, tq), NEG_INF, **f32),
            torch.zeros((b, h, tq), **f32))


def block_attn_finish(carry, dtype):
    acc, _, l = carry
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def mha_reference_fwd(q, k, v, *, causal=True, sm_scale=None):
    """``mha_reference`` plus the per-row logsumexp [B, H, T] f32 — the
    plain version of ``flash_attention_fwd``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _scores(q, k, causal, 0, 0, sm_scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o, torch.logsumexp(s, dim=-1)


#: while :func:`count_kernel_ops` is entered, ``[operations]`` K1-K3
#: did (the flop counter of ``train_step_flops`` cannot see inside the
#: extension); None otherwise
_KERNEL_OPS: list | None = None


@contextlib.contextmanager
def count_kernel_ops():
    """Tally the operations of the K1-K3 launches made inside: yields a
    one-element list whose entry grows by ``KERNEL_OPS_PER_PAIR[k]·D``
    operations per live (q, k) pair of each launch.  An enclosing tally
    also counts what a nested one did."""
    global _KERNEL_OPS
    prev, _KERNEL_OPS = _KERNEL_OPS, [0.0]
    mine = _KERNEL_OPS
    try:
        yield mine
    finally:
        _KERNEL_OPS = prev
        if prev is not None:
            prev[0] += mine[0]


#: operations per live (q, k) pair and unit of head dim: K1 does 2
#: products (S, O), K2 4 (S, dP, dV, dK), K3 3 (S, dP, dQ)
KERNEL_OPS_PER_PAIR = {"fwd": 4, "dkv": 8, "dq": 6}


def _tally(kernel: str, q, tk: int, causal: bool) -> None:
    if _KERNEL_OPS is None:
        return
    b, h, tq, d = q.shape
    # causal: query i sees keys 0..i (positions from 0 on both sides)
    pairs = (tq * tk if not causal else
             min(tq, tk) * (min(tq, tk) + 1) // 2 + max(0, tq - tk) * tk)
    _KERNEL_OPS[0] += float(KERNEL_OPS_PER_PAIR[kernel] * d * b * h * pairs)


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float):
    """Launch ``csrc/flash_fwd.cu`` on contiguous CUDA tensors
    q [B, H, Tq, D], k/v [B, H, Tk, D] (f32 or bf16).  Returns
    (o [B, H, Tq, D], lse [B, H, Tq] f32).  ``flash_fwd_cuda.launches``
    counts its launches, ``.tc_launches`` those of the tensor-core
    kernel (bf16)."""
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
    _check_tc_aligned("flash_fwd_cuda", q, k, v)
    if q.dtype == TC_DTYPE and not sm_scale > 0:
        # the tensor-core kernel scales the row max, not each score
        raise ValueError(f"flash_fwd_cuda needs sm_scale > 0 for bf16, "
                         f"got {sm_scale}")
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
    flash_fwd_cuda.tc_launches += int(q.dtype == TC_DTYPE)
    _tally("fwd", q, tk, causal)
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.tc_launches = 0


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


# -- backward: K2 (dK, dV) and K3 (dQ) ----------------------------------------

def flash_bwd_reference(q, k, v, do, lse, delta, *, causal=True,
                        sm_scale=None):
    """The plain version of K2 and K3: the backward formulas written out
    in f32 against the given residuals (lse, delta [B, H, Tq] f32),
    with the causal mask on positions counted from 0 on both sides:

    P = exp(S*scale - lse) (masked), dV = P^T dO,
    dS = P*(dO V^T - delta)*scale, dK = dS^T Q, dQ = dS K.

    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        mask = causal_mask(torch.arange(q.shape[2], device=q.device),
                           torch.arange(k.shape[2], device=q.device))
        p = torch.where(mask, p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_inputs(name, q, k, v, do, lse, delta):
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype) \
            or q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q/k/v/do of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape != do.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"{name} shapes: q=do [B,H,Tq,D], k=v [B,H,Tk,D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(do.shape)}"
        )
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3] \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(
            f"{name}: lse and delta must be float32 [B,H,Tq] = "
            f"{tuple(q.shape[:3])}; got {lse.dtype} {tuple(lse.shape)}, "
            f"{delta.dtype} {tuple(delta.shape)}"
        )
    if q.shape[3] not in FLASH_HEAD_DIMS:
        raise ValueError(
            f"{name} supports head dims {FLASH_HEAD_DIMS}, got {q.shape[3]}"
        )
    ts = (q, k, v, do, lse, delta)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous inputs")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: inputs on different devices")


def _bwd_call(fn, name, q, k, v, do, lse, delta, outs, causal, sm_scale):
    from theanompi_tpu_torch.kernels import _build

    b, h, tq, d = q.shape
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b * h, tq, k.shape[2], d, float(sm_scale), int(bool(causal)),
            KERNEL_DTYPES[q.dtype], stream,
        )
    _build.check(lib, err, name)


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float):
    """Launch K2 (``csrc/flash_bwd.cu``) on contiguous CUDA tensors:
    (dk, dv) [B, H, Tk, D] in the input dtype.  ``.launches`` counts
    its launches, ``.tc_launches`` those of the tensor-core kernel
    (bf16)."""
    _check_bwd_inputs("flash_bwd_dkv_cuda", q, k, v, do, lse, delta)
    _check_tc_aligned("flash_bwd_dkv_cuda", q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_call("tm_flash_bwd_dkv", "flash_bwd_dkv", q, k, v, do, lse, delta,
              (dk, dv), causal, sm_scale)
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.tc_launches += int(q.dtype == TC_DTYPE)
    _tally("dkv", q, k.shape[2], causal)
    return dk, dv


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.tc_launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool,
                      sm_scale: float):
    """Launch K3 (``csrc/flash_bwd.cu``) on contiguous CUDA tensors:
    dq [B, H, Tq, D] in the input dtype.  ``.launches`` counts its
    launches, ``.tc_launches`` those of the tensor-core kernel
    (bf16)."""
    _check_bwd_inputs("flash_bwd_dq_cuda", q, k, v, do, lse, delta)
    _check_tc_aligned("flash_bwd_dq_cuda", q, k, v, do)
    dq = torch.empty_like(q)
    _bwd_call("tm_flash_bwd_dq", "flash_bwd_dq", q, k, v, do, lse, delta,
              (dq,), causal, sm_scale)
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.tc_launches += int(q.dtype == TC_DTYPE)
    _tally("dq", q, k.shape[2], causal)
    return dq


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.tc_launches = 0


def flash_bwd_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K2 then K3 on contiguous CUDA tensors: (dq, dk, dv).  Each kernel
    counts its own launches (``flash_bwd_dkv_cuda.launches``,
    ``flash_bwd_dq_cuda.launches``)."""
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


def _bwd_lib():
    from theanompi_tpu_torch.kernels import _build

    lib = _build.load("flash_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_out in (("tm_flash_bwd_dkv", 2), ("tm_flash_bwd_dq", 1)):
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = ([p] * (6 + n_out)
                          + [i, i, i, i, ctypes.c_float, i, i, p])
            f.restype = i
    return lib


def flash_bwd(q, k, v, do, lse, delta, *, causal=True, sm_scale=None):
    """(dq, dk, dv) of attention against explicit residuals ``lse`` and
    ``delta`` [B, H, Tq] f32 (``delta = rowsum(dO*O)``).  CPU tensors
    take ``flash_bwd_reference``; CUDA tensors launch K2 and K3."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                   sm_scale=sm_scale)
    return flash_bwd_cuda(
        *(t.contiguous() for t in (q, k, v, do, lse, delta)), causal,
        sm_scale,
    )


class FlashAttention(torch.autograd.Function):
    """Attention with the flash residual contract: the forward is K1
    (saving q, k, v, o and lse), the backward is K2/K3 via
    :func:`flash_bwd` with ``delta = rowsum(dO*O)`` in f32."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type != "cpu":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, causal=ctx.causal,
                               sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, sm_scale=None):
    """Attention output [B, H, T, D], differentiable (see
    :class:`FlashAttention`)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, sm_scale)
