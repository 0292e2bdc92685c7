"""Block-table attention for the paged KV cache (kernel K4).

Port of ``theanompi_tpu/serving/paged_attention.py``.  Shapes:

- ``q``      ``[S, Q, Hkv, rep, hd]`` — Q query rows per slot (1 for
  plain decode);
- ``k_pool``/``v_pool`` ``[n_blocks + 1, Hkv, bs, hd]`` (last row =
  trash block);
- ``tables`` ``[S, MB]`` int32 (trash-padded past the owned prefix);
- ``pos``    ``[S, Q]`` int32 — row (s, q) attends positions
  ``<= pos[s, q]``.

``paged_attend_reference`` is the decoder's gather path: read the
slot's blocks into a contiguous ``[S, Hkv, MB*bs, hd]`` window, then
masked softmax attention.  ``paged_attend`` dispatches by device: CPU
tensors take the reference, CUDA tensors launch the hand-written
kernels of ``csrc/paged_attend.cu``, which stream the blocks from the
pools and never build the gathered window: the window is split into
fixed runs of positions, and the Q * rep query rows of a (slot, kv
head) into groups of 16, one CTA each (flash-decoding), and a second
kernel merges the splits' partial softmax states.  The split kernel
runs on the tensor cores in both dtypes: bf16 products in bf16, fp32
products in three TF32 passes.  Any number of kv heads and query rows
runs (a tensor-parallel rank passes its local heads).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from theanompi_tpu_torch.ops.attention import (
    KERNEL_DTYPES,
    NEG_INF,
    TC_DTYPE,
    TF32X3_DTYPE,
)

PAGED_HEAD_DIMS = (32, 64, 128)

_count_lock = threading.Lock()


def gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Block-table read: ``tables`` [S, MB] → [S, Hkv, MB*bs, hd], or a
    single row [MB] → [Hkv, MB*bs, hd], in position order."""
    g = pool[tables.long()]                 # [..., MB, Hkv, bs, hd]
    if tables.dim() == 2:
        s, mb, hkv, bs, hd = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(s, hkv, mb * bs, hd)
    mb, hkv, bs, hd = g.shape
    return g.permute(1, 0, 2, 3).reshape(hkv, mb * bs, hd)


def paged_attend_reference(q, k_pool, v_pool, tables, pos):
    """The gather path, the plain version of kernel K4.  Returns
    [S, Q, Hkv, rep, hd] in the pool dtype."""
    hd = q.shape[-1]
    t_pad = tables.shape[1] * k_pool.shape[2]
    kg = gather_blocks(k_pool, tables)
    vg = gather_blocks(v_pool, tables)
    scores = torch.einsum("sjkrd,sktd->sjkrt", q, kg).float() * (hd ** -0.5)
    valid = (
        torch.arange(t_pad, device=q.device)[None, None, :]
        <= pos[:, :, None].long()
    )[:, :, None, None, :]                  # [S, Q, 1, 1, T]
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    return torch.einsum("sjkrt,sktd->sjkrd", probs.to(vg.dtype), vg)


def paged_attend_cuda(q, k_pool, v_pool, tables, pos, *, ctas=None):
    """Launch ``csrc/paged_attend.cu`` on contiguous CUDA tensors (q and
    pools f32 or bf16 of one dtype, 16-byte aligned; tables/pos int32):
    the split kernel, then the merge (see ``launch_with``).
    ``paged_attend_cuda.launches`` counts its calls (one per
    split-and-merge pair), ``.tc_launches`` those of the bf16
    tensor-core split kernel, ``.tf32x3_launches`` those of the fp32 one
    (three TF32 passes on the tensor cores), and ``.launches_by_rows``
    them by query rows per (slot, kv head), Q * rep."""
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attend_cuda needs CUDA tensors, got {q.device}"
        )
    if not (q.dtype == k_pool.dtype == v_pool.dtype) \
            or q.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"paged_attend_cuda takes float32 or bfloat16 q/pools of one "
            f"dtype, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
        )
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attend_cuda: tables and pos must be int32")
    if q.dim() != 5 or k_pool.dim() != 4:
        raise ValueError(
            f"paged_attend_cuda shapes: q [S,Q,Hkv,rep,hd], pools "
            f"[NB+1,Hkv,bs,hd]; got {tuple(q.shape)}, "
            f"{tuple(k_pool.shape)}"
        )
    s, nq, hkv, rep, hd = q.shape
    _, hkv_p, bs, hd_p = k_pool.shape
    mb = tables.shape[-1]
    if (hkv, hd) != (hkv_p, hd_p) or k_pool.shape != v_pool.shape \
            or tuple(tables.shape) != (s, mb) \
            or tuple(pos.shape) != (s, nq):
        raise ValueError(
            f"paged_attend_cuda shape mismatch: q {tuple(q.shape)}, "
            f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(tables.shape)}, pos {tuple(pos.shape)}"
        )
    if hd not in PAGED_HEAD_DIMS:
        raise ValueError(
            f"paged_attend_cuda supports head dims {PAGED_HEAD_DIMS}, "
            f"got {hd}"
        )
    tensors = (q, k_pool, v_pool, tables, pos)
    if ctas is not None:
        if ctas.dtype != torch.int32 or ctas.numel() != 2:
            raise ValueError("paged_attend_cuda: ctas must be int32 [2]")
        tensors += (ctas,)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attend_cuda needs contiguous inputs")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attend_cuda: inputs on different devices")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attend_cuda needs 16-byte aligned q and "
                         "pools (it copies rows 16 bytes at a time)")
    out = launch_with(_paged_lib(), q, k_pool, v_pool, tables, pos,
                      ctas=ctas)
    _count_launch(nq * rep, q.dtype)
    return out


def _count_launch(rows: int, dtype: torch.dtype) -> None:
    """Count one launch of K4 in ``dtype`` on ``paged_attend_cuda``'s
    attributes, by route and by rows, under a lock: the fleet's replica
    threads launch it at once."""
    with _count_lock:
        paged_attend_cuda.launches += 1
        paged_attend_cuda.tc_launches += dtype == TC_DTYPE
        paged_attend_cuda.tf32x3_launches += dtype == TF32X3_DTYPE
        by_rows = paged_attend_cuda.launches_by_rows
        by_rows[rows] = by_rows.get(rows, 0) + 1


paged_attend_cuda.launches = 0
paged_attend_cuda.tc_launches = 0
paged_attend_cuda.tf32x3_launches = 0
paged_attend_cuda.launches_by_rows = {}


def launch_with(lib, q, k_pool, v_pool, tables, pos, *, ctas=None):
    """``tm_paged_attend`` of ``lib`` (the built library or a variant of
    its source) on inputs ``paged_attend_cuda`` has checked: allocates
    the splits' fp32 partials (o, and the row max and sum) for
    ceil(MB*bs / split length) splits, launches the split kernel and the
    merge on the current stream and returns the output.  ``ctas``: None,
    or an int32 [2] tensor to which the split kernel adds the CTAs it
    launched and those that did not exit early."""
    from theanompi_tpu_torch.kernels import _build

    _bind(lib)
    s, nq, hkv, rep, hd = q.shape
    bs, mb = k_pool.shape[2], tables.shape[-1]
    n_splits = -(-(mb * bs) // lib.tm_paged_attend_split_len())
    rows = nq * rep
    o_part = torch.empty((s, hkv, n_splits, rows, hd), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((s, hkv, n_splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tm_paged_attend(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), None if ctas is None else ctas.data_ptr(),
            out.data_ptr(), s, nq, hkv, rep, hd, bs, mb, float(hd ** -0.5),
            KERNEL_DTYPES[q.dtype], stream,
        )
    _build.check(lib, err, "paged_attend")
    return out


def _bind(lib):
    fn = lib.tm_paged_attend
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
        lib.tm_paged_attend_split_len.argtypes = []
        lib.tm_paged_attend_split_len.restype = i
        lib.tm_cuda_error_string.argtypes = [i]
        lib.tm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _paged_lib():
    from theanompi_tpu_torch.kernels import _build

    return _bind(_build.load("paged_attend"))


def split_len() -> int:
    """Positions per split of the card's K4 (one CTA each), as the built
    library reports it: the split boundaries are multiples of it,
    whatever the batch."""
    return _paged_lib().tm_paged_attend_split_len()


def paged_attend(q, k_pool, v_pool, tables, pos):
    """Block-table attention (see module docstring).  CPU tensors take
    the gather path; CUDA tensors launch kernel K4."""
    if q.device.type == "cpu":
        return paged_attend_reference(q, k_pool, v_pool, tables, pos)
    return paged_attend_cuda(
        q.contiguous(), k_pool, v_pool, tables.contiguous(),
        pos.contiguous(),
    )
