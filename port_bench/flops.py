"""The yardstick's arithmetic: device peaks, model FLOPs, and the
operations, bytes and least time of the port's kernels.

The kernel formulas are those of the repository's ``chip_smoke.py``
(``flash_ops``, ``bound``, ``bwd_bound``, ``paged_bound``) and the
peaks those of NVIDIA's H100 SXM data sheet, copied here so a change to
the program cannot move the yardstick.
"""

from __future__ import annotations

import subprocess

from port_bench.model import Dims

#: H100 SXM dense peaks: bf16 tensor cores, and HBM3 bytes a second
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

#: operations a (query, key) pair costs each flash kernel, per head dim
FLASH_OPS_PER_PAIR = {"fwd": 4, "dkv": 8, "dq": 6}


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds the card could take: ``ops`` at the bf16 peak
    against ``nbytes`` at the HBM rate."""
    return max(ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def flash_ops(kernel: str, shape, causal: bool = True) -> float:
    """Operations of one K1 (``"fwd"``), K2 (``"dkv"``) or K3 (``"dq"``)
    launch on q of ``shape`` [B, H, T, D] against keys of the same
    length: causal, query i sees keys 0..i."""
    b, h, t, d = shape
    pairs = b * h * (t * (t + 1) / 2 if causal else t * t)
    return FLASH_OPS_PER_PAIR[kernel] * d * pairs


def flash_bytes(kernel: str, shape, itemsize: int) -> float:
    """Bytes one launch reads and writes once: K1 q, k, v, o and the
    fp32 lse; K2 (dK, dV) and K3 (dQ) q, k, v, dO and their outputs, with
    the fp32 lse and delta."""
    b, h, t, d = shape
    numel = b * h * t * d
    if kernel == "fwd":
        return 4 * numel * itemsize + b * h * t * 4
    n_out = 2 if kernel == "dkv" else 1
    return (4 + n_out) * numel * itemsize + 2 * b * h * t * 4


def flash_bound_s(kernel: str, shape, itemsize: int = 2) -> float:
    return bound_s(flash_ops(kernel, shape), flash_bytes(kernel, shape,
                                                         itemsize))


def paged_bound_s(q_shape, block_size: int, max_pos_per_slot,
                  n_table: int, itemsize: int = 2) -> float:
    """Least seconds of one K4 launch (split and combine): every slot's
    blocks up to its last position read once (K and V), q and the
    output, the tables and positions, against ``4·hd`` operations per
    walked position and query row.  ``q_shape`` is [S, Q, Hkv, rep, hd];
    ``max_pos_per_slot`` each slot's largest query position."""
    s, nq, hkv, rep, hd = q_shape
    walked = sum((int(p) // block_size + 1) * block_size
                 for p in max_pos_per_slot)
    q_numel = s * nq * hkv * rep * hd
    nbytes = (2 * walked * hkv * hd * itemsize + 2 * q_numel * itemsize
              + n_table * 4 + s * nq * 4)
    return bound_s(4 * walked * hkv * rep * nq * hd, nbytes)


# -- model FLOPs --------------------------------------------------------------

def matmul_params(d: Dims) -> dict:
    """Parameters of the products a token runs through, by part: a
    layer's attention projections, its FFN as one token uses it (the
    routed experts at top-k and the router), and the head; the
    embedding is a lookup."""
    hd = d.head_dim
    attn = d.dim * hd * (2 * d.n_heads + 2 * d.n_kv_heads)
    if d.n_experts:
        ffn = d.top_k * 3 * d.dim * d.ffn + d.dim * d.n_experts
    else:
        ffn = 3 * d.dim * d.ffn
    return {"layer": attn + ffn, "head": d.dim * d.vocab}


def train_step_flops(d: Dims, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 × the active matmul
    parameters a token, plus causal attention's 6·seq·dim a layer a
    token.  Remat's replayed forward and capacity padding are work the
    model does not need, and are not counted."""
    p = matmul_params(d)
    n_active = d.n_layers * p["layer"] + p["head"]
    tokens = batch * seq
    return 6 * n_active * tokens + 6 * seq * d.dim * d.n_layers * tokens


def serve_token_flops(d: Dims, context: float) -> float:
    """Forward FLOPs of one token at ``context`` earlier positions:
    2 × the matmul parameters, plus 4·context·dim a layer (scores and
    the weighted sum)."""
    p = matmul_params(d)
    return (2 * (d.n_layers * p["layer"] + p["head"])
            + 4 * context * d.dim * d.n_layers)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them
    (the peaks assume the full 700 W)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
