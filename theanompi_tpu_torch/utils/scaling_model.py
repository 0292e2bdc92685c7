"""Analytical multi-chip scaling predictor (port of
``theanompi_tpu/utils/scaling_model.py``; no torch at import).

The same per-step exchange-bytes / compute-FLOPs model with the same
formulas and the same ``chip=`` defaults (``V5E``): a BSP step is

    t_step(n) = t_comp + t_exposed(n)
    t_ar(n)   = 2 * wire_bytes * (n-1)/n / (links * link_bw)
    t_exposed = clamp(t_ar - overlap_budget, 0, t_ar)

with ``t_ar`` the bidirectional ring allreduce bound over a chip's
usable links and the overlap budget the backward's share of compute.
Pass ``chip=H100`` for the card: ``H100`` holds the datasheet values
of an NVIDIA H100 80GB HBM3 (SXM): 989 dense bf16 TFLOP/s, 80 GB of
HBM at 3.35 TB/s, NVLink 4 as 18 links of 25 GB/s a direction, and a
400 Gb/s NIC a GPU.  ``ici_links_used`` describes a TPU torus (one
axis up to 16 chips, both beyond); an NVLink switch gives every card
all its links to every other, so with ``chip=H100`` pass ``links=
H100.ici_links`` where a function takes ``links``.

``peak_flops_per_chip`` reads a torch device's name (``None`` for the
CPU, as the JAX one is ``None`` off the TPU).  ``cost_analysis_totals``
(XLA's cost analysis) has no counterpart: a step's FLOPs come from the
models' ``train_step_flops()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# --------------------------------------------------------------------------
# chip + slice specs (public datasheet values)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16: float        # dense bf16 FLOP/s
    hbm_bytes: float        # HBM capacity per chip
    hbm_bw: float           # HBM bandwidth, bytes/s
    ici_link_bw: float      # per ICI link, per direction, bytes/s
    ici_links: int          # torus links per chip (2D torus: 4)
    dcn_bw_per_chip: float  # bytes/s of DCN egress per chip (host NIC / 8)


V5E = ChipSpec(
    name="TPU v5e",
    peak_bf16=197e12,
    hbm_bytes=16 * 2**30,
    hbm_bw=819e9,
    ici_link_bw=45e9,
    ici_links=4,
    dcn_bw_per_chip=3.125e9,   # 200 Gbps NIC per 8-chip host
)

H100 = ChipSpec(
    name="NVIDIA H100",
    peak_bf16=989e12,          # dense bf16 (SXM)
    hbm_bytes=80e9,
    hbm_bw=3.35e12,            # HBM3
    ici_link_bw=25e9,          # NVLink 4: per link, per direction
    ici_links=18,
    dcn_bw_per_chip=50e9,      # a 400 Gb/s NIC per GPU
)

#: peak dense bf16 FLOP/s per chip by PJRT device_kind prefix — THE
#: MFU denominator (bench.py and the step-phase profiler share it)
PEAK_BF16 = {
    "TPU v2": 45e12,
    "TPU v3": 123e12,
    "TPU v4": 275e12,
    "TPU v5 lite": 197e12,
    "TPU v5e": 197e12,
    "TPU v5": 459e12,
    "TPU v5p": 459e12,
    "TPU v6 lite": 918e12,
    "TPU v6e": 918e12,
    "NVIDIA H100": 989e12,
}


def peak_flops_per_chip(devices) -> float | None:
    """Datasheet peak for the first device's kind: a ``torch.device``
    (or its string) of a card is read by ``torch.cuda.get_device_name``
    and matched against ``PEAK_BF16``'s prefixes; the CPU (and a card
    of no listed kind) gives None, as CPU-mesh MFU figures would be
    meaningless as absolutes."""
    if not devices:
        return None
    kind = getattr(devices[0], "device_kind", None)
    if kind is None:
        import torch

        dev = torch.device(devices[0])
        if dev.type != "cuda":
            return None
        kind = torch.cuda.get_device_name(dev)
    for name, peak in PEAK_BF16.items():
        if kind.startswith(name):
            return peak
    return None


def ici_links_used(n_chips: int) -> int:
    """Links a BSP allreduce can drive on an n-chip v5e slice: one
    torus axis (2 directions) up to 16 chips, both axes on a 2D slice
    (8x8 = 64).  Conservative for in-between rectangles."""
    return 4 if n_chips > 16 else 2


# --------------------------------------------------------------------------
# BSP allreduce + efficiency
# --------------------------------------------------------------------------


def allreduce_time(wire_bytes: float, n_chips: int,
                   chip: ChipSpec = V5E, links: int | None = None,
                   bw: float | None = None) -> float:
    """Bidirectional ring/torus allreduce seconds for ``wire_bytes``
    per chip (reduce-scatter + all-gather: 2*B*(n-1)/n on the wire).
    ``bw`` overrides the per-chip egress (bytes/s) — the DCN case,
    where the ring crosses host NICs instead of ICI links."""
    if n_chips <= 1:
        return 0.0
    if bw is None:
        links = ici_links_used(n_chips) if links is None else links
        bw = links * chip.ici_link_bw
    return 2.0 * wire_bytes * (n_chips - 1) / n_chips / bw


# --------------------------------------------------------------------------
# compressed wire (exch_compression int8/fp8 — parallel/exchange)
# --------------------------------------------------------------------------

#: bytes per gradient element each wire format ships (the fp32 master
#: is 4 bytes/element; the compression factor is 4/this)
WIRE_ELEM_BYTES = {
    "fp32": 4.0, None: 4.0, "none": 4.0,
    "bf16": 2.0,
    "int8": 1.0, "fp8": 1.0,
}


def exchange_wire_bytes(
    param_bytes: float,
    *,
    wire: str | None = None,
    n_shards: int = 8,
    bucket_bytes: float = 4 * 2**20,
) -> float:
    """Bytes ONE phase of the exchange puts on the wire per chip-step
    for a ``param_bytes`` fp32 gradient pack.  The compressed wire
    (``int8``/``fp8``) ships 1 byte per element plus one f32 scale
    per (bucket x shard) chunk — the scale overhead is what makes
    tiny buckets lose (PERFORMANCE.md: when int8 loses)."""
    n_elems = param_bytes / 4.0
    per_elem = WIRE_ELEM_BYTES[wire]
    payload = n_elems * per_elem
    if per_elem == 1.0:
        n_buckets = max(1.0, math.ceil(param_bytes / bucket_bytes))
        payload += 4.0 * n_buckets * n_shards
    return payload


def compression_table(
    *,
    step_time_1chip: float,
    param_bytes: float,
    wire: str = "int8",
    baseline_wire: str = "fp32",
    chip_counts=(8, 16, 64),
    transport: str = "ici",
    chip: ChipSpec = V5E,
    overlap_frac: float = 2.0 / 3.0,
    bucket_bytes: float = 4 * 2**20,
) -> list[dict]:
    """Predicted win of the quantized wire over ``baseline_wire`` at
    8/16/64 chips: at 16-64 chips
    over DCN the baseline's ``exposed_comm_frac`` dominates the step,
    and cutting wire bytes 4x shrinks it directly.

    ``transport="dcn"`` rings over the hosts' NIC share
    (``chip.dcn_bw_per_chip``) instead of ICI — the multi-host regime
    the compression is FOR (ICI at 8 chips usually hides the fp32
    wire already; the model shows exactly that).

    One row per chip count::

        {"n_chips", "wire_mb", "wire_mb_baseline",
         "wire_reduction", "t_exposed_ms", "t_exposed_baseline_ms",
         "efficiency", "efficiency_baseline", "speedup"}
    """
    rows = []
    for n in chip_counts:
        bw = chip.dcn_bw_per_chip if transport == "dcn" else None
        out = {}
        for label, w in (("", wire), ("_baseline", baseline_wire)):
            wb = exchange_wire_bytes(
                param_bytes, wire=w, n_shards=n,
                bucket_bytes=bucket_bytes,
            )
            t_ar = allreduce_time(wb, n, chip, bw=bw)
            exposed = max(0.0, t_ar - overlap_frac * step_time_1chip)
            out[f"wire_mb{label}"] = wb / 2**20
            out[f"t_exposed{label}_ms"] = exposed * 1e3
            out[f"efficiency{label}"] = step_time_1chip / (
                step_time_1chip + exposed
            )
        rows.append({
            "n_chips": n,
            "transport": transport,
            "wire": wire,
            "wire_reduction": (
                out["wire_mb_baseline"] / out["wire_mb"]
            ),
            "speedup": out["efficiency"] / out["efficiency_baseline"],
            **out,
        })
    return rows


def bsp_efficiency(
    *,
    step_time_1chip: float,
    param_bytes: float,
    wire_dtype_bytes: int = 4,
    n_chips: int,
    chip: ChipSpec = V5E,
    overlap_frac: float = 2.0 / 3.0,
    compression: str | None = None,
    bw: float | None = None,
) -> dict:
    """Predicted BSP scaling efficiency at ``n_chips`` (per-chip batch
    held constant — the reference's weak-scaling regime, SURVEY §6).

    ``step_time_1chip``: measured single-chip step seconds.
    ``param_bytes``: full parameter-tree bytes at fp32 master width
    (what the grads occupy before wire cast).
    ``wire_dtype_bytes``: 4 for the ici32 strategy, 2 for ici16 —
    the nccl32/nccl16 analogue (SURVEY §5.8).
    ``overlap_frac``: fraction of compute the allreduce can hide
    under (default: the backward ~2/3 of a fwd+bwd step, which is
    where XLA schedules grad collectives).
    ``compression`` (``int8``/``fp8``): the quantized wire — 1 byte
    per gradient element + per-chunk scales (supersedes
    ``wire_dtype_bytes``; ``exchange_wire_bytes``).
    ``bw``: per-chip exchange bandwidth override (bytes/s) — the
    MEASURED-anchor path (tests/test_scaling_model.py validates the
    predictor against ``trace_comm``-measured localhost BSP runs by
    calibrating this from one world size and predicting another),
    and the DCN case where the ring crosses host NICs.
    """
    if compression in ("int8", "fp8"):
        wire_bytes = exchange_wire_bytes(
            param_bytes, wire=compression, n_shards=n_chips
        )
    else:
        wire_bytes = param_bytes * wire_dtype_bytes / 4.0
    t_ar = allreduce_time(wire_bytes, n_chips, chip, bw=bw)
    exposed = max(0.0, t_ar - overlap_frac * step_time_1chip)
    eff_overlap = step_time_1chip / (step_time_1chip + exposed)
    eff_serial = step_time_1chip / (step_time_1chip + t_ar)
    return {
        "n_chips": n_chips,
        "wire_mb": wire_bytes / 2**20,
        "t_comp_ms": step_time_1chip * 1e3,
        "t_allreduce_ms": t_ar * 1e3,
        "t_exposed_ms": exposed * 1e3,
        "efficiency_overlap": eff_overlap,
        "efficiency_no_overlap": eff_serial,
    }


def bucketed_overlap(
    *,
    wire_bytes: float,
    n_chips: int,
    step_time_1chip: float,
    bucket_bytes: float = 4 * 2**20,
    overlap_frac: float = 2.0 / 3.0,
    launch_s: float = 10e-6,
    chip: ChipSpec = V5E,
    links: int | None = None,
) -> dict:
    """Predicted win of the bucketed exchange (``exchange_bucket_mb``)
    over the monolithic serialized tail, from bucket count and
    per-bucket wire time.

    Model (the pipeline bound composed with ``bsp_efficiency``'s
    overlap budget):

    - the MONOLITHIC exchange is one collective issued after the
      packed grads exist — i.e. after the whole backward — so its
      wire time is fully exposed: ``t_exposed_mono = t_ar(B)``;
    - the BUCKETED exchange splits B into ``ceil(B / bucket_bytes)``
      buckets; each bucket's reduce-scatter depends only on its own
      leaves, so the scheduler can hide wire under the
      ``overlap_frac`` backward budget.  Two floors remain exposed:
      the launch overhead (``n_buckets * launch_s`` — why shrinking
      buckets eventually LOSES; the DDP-default ~4 MiB sits near the
      knee) and the LAST bucket's wire time, which has no later
      compute to hide under: ``t_exposed = max(t_wire_total -
      overlap_budget, t_bucket)``;
    - ``bucket_bytes <= 0`` degrades to the monolithic model (the
      ``bucket_mb=0`` config path).

    Returns the predicted ``exposed_comm_frac`` for both arms — the
    quantity ``bench.py``'s bucketed A/B row and ``trace_comm`` then
    measure.
    """
    if n_chips <= 1 or wire_bytes <= 0:
        return {
            "n_buckets": 1, "t_wire_ms": 0.0,
            "t_exposed_monolithic_ms": 0.0,
            "t_exposed_bucketed_ms": 0.0, "overlap_win_ms": 0.0,
            "exposed_comm_frac_monolithic": 0.0,
            "exposed_comm_frac_bucketed": 0.0,
        }
    n_buckets = (
        1 if bucket_bytes <= 0 or bucket_bytes >= wire_bytes
        else math.ceil(wire_bytes / bucket_bytes)
    )
    t_mono = allreduce_time(wire_bytes, n_chips, chip, links) + launch_s
    if n_buckets == 1:
        t_wire, t_bucket, t_exposed = t_mono, t_mono, t_mono
    else:
        t_bucket = (
            allreduce_time(wire_bytes / n_buckets, n_chips, chip, links)
            + launch_s
        )
        t_wire = n_buckets * t_bucket
        budget = overlap_frac * step_time_1chip
        t_exposed = max(t_wire - budget, t_bucket)

    def frac(exposed: float) -> float:
        return exposed / (step_time_1chip + exposed)

    return {
        "n_buckets": n_buckets,
        "t_wire_ms": t_wire * 1e3,
        "t_exposed_monolithic_ms": t_mono * 1e3,
        "t_exposed_bucketed_ms": t_exposed * 1e3,
        "overlap_win_ms": (t_mono - t_exposed) * 1e3,
        "exposed_comm_frac_monolithic": frac(t_mono),
        "exposed_comm_frac_bucketed": frac(t_exposed),
    }


def loader_pipeline(
    *,
    batch_bytes: float,
    step_time_s: float,
    host_bw: float = 2e9,
    fetch_s: float = 0.0,
    depth: int = 2,
) -> dict:
    """Predicted win of the streaming loader (``loader_pipeline``
    knob) over the synchronous feed, from batch bytes / host→device
    bandwidth / compute step time.

    Model:

    - the SYNCHRONOUS feed serializes host work in front of every
      step: ``t_host = fetch_s + batch_bytes / host_bw`` and
      ``t_step_sync = t_host + step_time_s`` — the cost the profiler
      reports as ``host_gap`` (+ the traced ``host_load`` sliver);
    - the PIPELINED feed runs the same host work on a producer
      thread UNDER the previous step's compute.  When ``t_host <=
      step_time_s`` the producer keeps the ring full and the steady
      state is compute-bound: ``t_step_pipe = step_time_s``,
      ``host_gap ≈ 0``;
    - when the producer CANNOT keep up (``t_host > step_time_s``)
      the ring drains once (depth batches of headroom) and the
      steady state is producer-bound: every step waits ``t_host -
      step_time_s`` — the ``starved_frac`` of step time the consumer
      spends blocked (the loader's degrade path makes this a
      synchronous fetch, never a deadlock).

    Returns ms legs + fracs in the house predictor shape; the bench
    ``loader`` row measures the same quantities.
    """
    if depth < 2:
        raise ValueError(f"depth must be >= 2, got {depth}")
    t_host = fetch_s + (
        batch_bytes / host_bw if host_bw > 0 else 0.0
    )
    t_sync = t_host + step_time_s
    stall = max(0.0, t_host - step_time_s)
    t_pipe = step_time_s + stall
    return {
        "t_host_ms": t_host * 1e3,
        "t_step_sync_ms": t_sync * 1e3,
        "t_step_pipelined_ms": t_pipe * 1e3,
        "overlap_win_ms": (t_sync - t_pipe) * 1e3,
        "host_gap_frac_sync": t_host / t_sync if t_sync else 0.0,
        "host_gap_frac_pipelined": stall / t_pipe if t_pipe else 0.0,
        "starved_frac": stall / t_pipe if t_pipe else 0.0,
        "producer_bound": stall > 0.0,
        "depth": depth,
    }


def elastic_resume_cost(
    *,
    param_bytes: float,
    n_old: int,
    n_new: int,
    step_time_s: float,
    optimizer: str = "adam",
    error_feedback: bool = False,
    host_bw: float = 2e9,
) -> dict:
    """Predicted cost of an ELASTIC resume (gather + re-scatter the
    flat exchange state onto a new world, ``utils/reshard.py``) vs
    the throughput of just continuing at the smaller world.

    Bytes moved through host memory: the zero1 optimizer state at
    fp32 master width (adam m+v = 2x the parameter bytes, momentum
    1x), plus — with error feedback — the per-device r1 residuals
    (``n_old`` full-width f32 buffers: each device carries its own
    residual of the WHOLE pack) and the r2 shard residual.  Each
    byte is read in the saved layout and written in the new one
    (2x on the wire through ``host_bw`` — disk/DCN-limited in
    practice, the knob to override).

    The comparison the operator actually faces after losing hardware:
    **reshard now** and train at ``n_new/n_old`` throughput, or
    **wait** for replacement capacity at zero throughput.  Elastic
    wins for any outage longer than ``reshard_s`` (progress starts
    immediately after the reshard); ``reshard_steps_equiv`` prices
    the pause in per-replica-batch steps at the old world's step
    time."""
    opt_mult = {"adam": 2.0, "momentum": 1.0, "sgd": 0.0}[optimizer]
    state_bytes = opt_mult * param_bytes
    if error_feedback:
        # r1: n_old per-device full-width f32 residuals; r2: ONE
        # full-width buffer (per-element shard-owner state)
        state_bytes += n_old * param_bytes + param_bytes
    moved = 2.0 * state_bytes          # gather + re-scatter
    reshard_s = moved / host_bw
    return {
        "state_bytes": state_bytes,
        "moved_bytes": moved,
        "reshard_s": reshard_s,
        "reshard_steps_equiv": (
            reshard_s / step_time_s if step_time_s else None
        ),
        "throughput_frac": n_new / n_old,
        "break_even_outage_s": reshard_s,
        "n_old": n_old,
        "n_new": n_new,
    }


def predict_table(
    *,
    step_time_1chip: float,
    param_bytes: float,
    wire_dtype_bytes: int = 4,
    chip_counts=(8, 16, 64),
    chip: ChipSpec = V5E,
) -> list[dict]:
    """The PODS.md table: one row per slice size."""
    return [
        bsp_efficiency(
            step_time_1chip=step_time_1chip,
            param_bytes=param_bytes,
            wire_dtype_bytes=wire_dtype_bytes,
            n_chips=n,
            chip=chip,
        )
        for n in chip_counts
    ]


# --------------------------------------------------------------------------
# Llama memory + step-time sizing (BASELINE config 5: Llama-3-8B)
# --------------------------------------------------------------------------


def llama_param_count(cfg: dict) -> int:
    """Exact parameter count of this repo's Llama (models/llama.py
    layout: attn q/k/v/o + SwiGLU gate/up/down + 2 RMSNorm weights
    per layer, embed + final norm + separate unembed)."""
    d = int(cfg["dim"])
    L = int(cfg["n_layers"])
    v = int(cfg["vocab"])
    f = int(cfg["ffn_dim"])
    kv = int(cfg["n_kv_heads"]) * (d // int(cfg["n_heads"]))
    per_layer = (
        d * d            # wq
        + 2 * d * kv     # wk, wv (GQA)
        + d * d          # wo
        + 3 * d * f      # gate, up, down
        + 2 * d          # rms norms
    )
    return v * d + L * per_layer + d + d * v


def llama_hbm_per_chip(
    cfg: dict,
    *,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    dp: int = 1,
    zero1: bool = False,
    batch_per_replica: int = 1,
    seq_len: int | None = None,
    remat: bool = True,
    optimizer: str = "adam",
    compute_bytes: int = 2,
) -> dict:
    """Per-chip HBM bytes for a sharded Llama training step.

    Accounting (models/llama.py layout):
    - params: fp32 master, matrices sharded by tp, layers by pp;
      norms replicated.  Approximation: the whole tree divides by
      tp*pp (norm weights are <0.01% of 8B).
    - optimizer: adam m+v fp32 over the same shard (momentum: 1x).
      With ``zero1=True`` (the ``zero1`` exchange strategy) the m+v
      buffers additionally shard 1/dp over the data axis — the ZeRO-1
      win: per-chip optimizer bytes divide by the DP replica count,
      so predicted max batch RISES with N (``llama_max_batch``).
    - gradients: one fp32 shadow of the shard (transient but peak;
      zero1 reduce-scatters them on the wire but the pre-exchange
      local grads still exist at peak, so they do NOT divide by dp).
    - activations (remat=True): each layer saves its boundary input
      [B, T/sp, d] in compute dtype; plus the embed output, the
      final-norm input, and the flash residuals of ONE layer being
      recomputed (q,k,v,o + lse ~ 5 * boundary).
    - the vocab-sharded softmax-xent never materializes [B, T, V]
      logits (parallel/tp.py) — excluded by design.

    Returns a dict of components + ``total`` + ``fits_16g``.
    """
    T = int(seq_len if seq_len is not None else cfg["seq_len"])
    P = llama_param_count(cfg)
    shard = tp * pp
    p_bytes = 4.0 * P / shard
    opt_mult = {"adam": 2.0, "momentum": 1.0, "sgd": 0.0}[optimizer]
    opt_shard = shard * (dp if zero1 else 1)
    opt_bytes = opt_mult * 4.0 * P / opt_shard
    grad_bytes = 4.0 * P / shard

    d = int(cfg["dim"])
    L = int(cfg["n_layers"])
    b = batch_per_replica
    boundary = b * (T // sp) * d * compute_bytes
    if remat:
        act_bytes = (L / pp + 2) * boundary + 5 * boundary
    else:
        # no remat: ~10 saved tensors per layer (attn + ffn interms)
        act_bytes = (L / pp) * 10 * boundary + 2 * boundary
    total = p_bytes + opt_bytes + grad_bytes + act_bytes
    return {
        "params_gb": p_bytes / 2**30,
        "opt_gb": opt_bytes / 2**30,
        "grads_gb": grad_bytes / 2**30,
        "acts_gb": act_bytes / 2**30,
        "total_gb": total / 2**30,
        "fits_16g": total < V5E.hbm_bytes,
        "param_count": P,
    }


def llama_max_batch(
    cfg: dict,
    *,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    dp: int = 1,
    zero1: bool = False,
    seq_len: int | None = None,
    remat: bool = True,
    optimizer: str = "adam",
    chip: ChipSpec = V5E,
    limit: int = 65536,
) -> int:
    """Largest per-replica batch whose predicted per-chip HBM fits the
    chip (the max-batch-at-fixed-HBM half of the zero1 A/B: freeing
    ~opt_bytes*(1-1/dp) of HBM converts directly into batch — the
    lever on the memory-limited zoo rows).  0 = even batch 1 spills."""

    def fits(b: int) -> bool:
        return (
            llama_hbm_per_chip(
                cfg, tp=tp, sp=sp, pp=pp, dp=dp, zero1=zero1,
                batch_per_replica=b, seq_len=seq_len, remat=remat,
                optimizer=optimizer,
            )["total_gb"] * 2**30 < chip.hbm_bytes
        )

    if not fits(1):
        return 0
    lo, hi = 1, 2
    while hi < limit and fits(hi):
        lo, hi = hi, hi * 2
    hi = min(hi, limit)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def llama_kv_bytes_per_token(cfg: dict, *, kv_dtype_bytes: int = 2) -> int:
    """Bytes ONE cached token occupies (K + V, all layers, compact
    GQA heads — the serving cache layout, serving/decoder.py)."""
    hd = int(cfg["dim"]) // int(cfg["n_heads"])
    return (
        2 * int(cfg["n_layers"]) * int(cfg["n_kv_heads"]) * hd
        * kv_dtype_bytes
    )


def serving_roofline(
    cfg: dict,
    *,
    batch: int,
    context: int,
    tp: int = 1,
    param_dtype_bytes: int = 2,
    kv_dtype_bytes: int = 2,
    chip: ChipSpec = V5E,
    max_seq: int | None = None,
    block_size: int | None = None,
    prefix_hit_frac: float = 0.0,
) -> dict:
    """HBM-bandwidth roofline for the serving DECODE step.

    Generating one token per slot is matmul-starved: every weight
    matrix is read ONCE per step (amortized over the whole batch)
    and each slot additionally reads its own KV history — at batch 1
    the step moves ~all parameter bytes to produce ONE token, so
    decode is bound by HBM bandwidth, not FLOPs (the opposite regime
    from training, where ``llama_step_flops`` vs peak MFU governs).

        t_step   = (param_bytes/tp + batch * kv_context_bytes/tp)
                   / hbm_bw
        tokens/s = batch / t_step

    ``crossover_batch`` is where the batch's KV reads equal the
    weight reads — past it, adding slots stops being ~free and
    tokens/s per slot degrades toward the KV-bandwidth bound.  The
    bench row's measured tokens/s at each offered load is the
    CPU-mesh analogue of this curve; on real v5e the prediction is
    checkable against the datasheet 819 GB/s.

    Paged extensions (serving v2, ``serving/blocks.py``), emitted
    when ``block_size`` is given:

    - ``paged_kv_bytes_per_slot`` — HBM a request at ``context``
      tokens actually HOLDS under paging (its blocks, rounded up to
      ``block_size``), vs the contiguous layout's
      ``contiguous_kv_bytes_per_slot`` = ``max_seq`` rows regardless
      of use; ``paged_hbm_saving`` is their ratio and
      ``max_slots_paged`` / ``max_slots_contiguous`` the concurrent
      requests one chip's HBM then carries — the capacity win paging
      buys (decode BANDWIDTH is unchanged: both layouts read the
      same ``context`` tokens per step).
    - ``prefix_hit_frac`` (radix cache, ``serving/prefix_cache.py``):
      fraction of prompt tokens adopted instead of prefilled.
      Prefill is compute-bound, so predicted TTFT scales by
      ``(1 - hit)``: ``prefix_ttft_speedup`` = 1 / (1 - hit).
    """
    p_bytes = llama_param_count(cfg) * param_dtype_bytes / tp
    kv_tok = llama_kv_bytes_per_token(
        cfg, kv_dtype_bytes=kv_dtype_bytes
    ) / tp
    kv_slot = kv_tok * context
    bytes_per_step = p_bytes + batch * kv_slot
    t_step = bytes_per_step / chip.hbm_bw
    out = {
        "param_bytes_per_chip": p_bytes,
        "kv_bytes_per_slot": kv_slot,
        "bytes_per_step": bytes_per_step,
        "bytes_per_token": bytes_per_step / batch,
        "step_ms": t_step * 1e3,
        "tokens_per_sec": batch / t_step,
        "tokens_per_sec_per_slot": 1.0 / t_step,
        "param_read_frac": p_bytes / bytes_per_step,
        "crossover_batch": p_bytes / kv_slot if kv_slot else None,
    }
    if block_size is not None:
        blocks_held = -(-(context + 1) // int(block_size))
        paged_slot = kv_tok * blocks_held * int(block_size)
        out["paged_kv_bytes_per_slot"] = paged_slot
        hbm_for_kv = chip.hbm_bytes - p_bytes
        out["max_slots_paged"] = int(hbm_for_kv // paged_slot)
        if max_seq is not None:
            contig_slot = kv_tok * int(max_seq)
            out["contiguous_kv_bytes_per_slot"] = contig_slot
            out["paged_hbm_saving"] = contig_slot / paged_slot
            out["max_slots_contiguous"] = int(hbm_for_kv // contig_slot)
        # fused paged-attention kernel arithmetic intensity
        # (serving/paged_attention.py).  The jnp gather path
        # materializes the padded [batch, Hkv, MB*bs, hd] window per
        # layer: pool rows are read, written back as the gathered
        # copy, and read again by the matmuls (~3x the PADDED
        # window's bytes); the fused kernel moves each cached token's
        # K/V once, at `context` tokens.  Intensity sits far below
        # the chip's ridge — the kernel is bandwidth-bound by
        # construction, so bytes saved convert directly into step
        # time (`paged_attend_frac` in the serving_paged row is the
        # measured check).
        n_heads = int(cfg["n_heads"])
        hd = int(cfg["dim"]) // n_heads
        L = int(cfg["n_layers"])
        t_padded = (
            -(-int(max_seq if max_seq is not None else context)
              // int(block_size)) * int(block_size)
        )
        attend_flops = 4.0 * L * batch * (n_heads / tp) * context * hd
        bytes_fused = batch * kv_tok * context
        bytes_gather = 3.0 * batch * kv_tok * t_padded
        out["paged_attend_flops_per_step"] = attend_flops
        out["paged_attend_bytes_fused"] = bytes_fused
        out["paged_attend_bytes_gather"] = bytes_gather
        out["paged_attend_intensity"] = attend_flops / bytes_fused
        out["ridge_intensity"] = chip.peak_bf16 / chip.hbm_bw
        out["paged_attend_hbm_speedup"] = bytes_gather / bytes_fused
    if prefix_hit_frac:
        assert 0.0 <= prefix_hit_frac < 1.0, prefix_hit_frac
        out["prefix_hit_frac"] = prefix_hit_frac
        out["prefix_ttft_speedup"] = 1.0 / (1.0 - prefix_hit_frac)
    return out


def speculation_speedup(
    *,
    k: int,
    accept_rate: float,
    verify_cost_ratio: float = 1.0,
    conditional: bool = False,
) -> dict:
    """Predicted win of speculative decoding at verify window ``k``
    (1 committed token + ``k-1`` drafts per step,
    ``Engine(speculate_k=k)``).

    ``accept_rate`` defaults to the UNCONDITIONAL accepted/offered
    ratio — exactly ``ServingRecorder.summary()['accept_rate']``
    (accepted_tokens / drafted_tokens).  By linearity the expected
    committed tokens per full-window step is then EXACTLY
    ``E = 1 + a * (k - 1)`` (accepted prefix + the model's bonus
    token) — no distributional assumption; the figure only
    overestimates when the drafter offers short windows (fewer than
    ``k-1`` drafts), which the measured ``tokens_per_step`` exposes.
    ``conditional=True`` instead reads ``accept_rate`` as the
    per-draft CONDITIONAL probability (draft ``i`` matters only if
    drafts ``1..i-1`` matched — a drafter-quality model, not the
    recorder datum): ``E = sum_{i=0}^{k-1} a^i = (1-a^k)/(1-a)``.
    Do NOT feed the recorder's ratio to the conditional form — the
    unconditional ratio is systematically lower and would
    underpredict.

    Decode is HBM-bound, so a verify step costs ~one decode step
    (same weight read, same KV history read; the k-row activations
    are noise) — ``verify_cost_ratio`` prices any measured
    deviation.  Speedup = ``E / verify_cost_ratio``; at ``a = 0``
    both forms degrade to exactly 1.0 (one token per step), the
    engine's tested floor.
    """
    assert k >= 1 and 0.0 <= accept_rate <= 1.0, (k, accept_rate)
    a = float(accept_rate)
    if conditional:
        expected = float(k) if a >= 1.0 else (1.0 - a ** k) / (1.0 - a)
    else:
        expected = 1.0 + a * (k - 1)
    return {
        "k": int(k),
        "accept_rate": a,
        "conditional": bool(conditional),
        "tokens_per_step": expected,
        "verify_cost_ratio": float(verify_cost_ratio),
        "speedup": expected / float(verify_cost_ratio),
    }


def fleet_roofline(
    cfg: dict,
    *,
    offered_tokens_per_sec: float,
    context: int,
    tp: int = 1,
    batch: int = 8,
    chip: ChipSpec = V5E,
    target_util: float = 0.8,
    **roofline_kw,
) -> dict:
    """Replica-count planning for a target offered load (the fleet
    router, ``serving/router.py``).

    One replica's decode capacity comes from ``serving_roofline`` at
    the replica's slot count (``batch``); a fleet of R replicas
    serves ``R * capacity`` tokens/s.  The KNEE is the smallest R
    whose utilization ``rho = offered / (R * capacity)`` drops below
    ``target_util`` — past the knee, adding replicas buys headroom,
    not latency.  Each row carries the M/M/1-style queue-wait
    inflation ``1 / (1 - rho)`` (rho < 1): the TTFT p95 proxy that
    explodes as a replica count SATURATES, which is what the bench's
    offered-load sweep shows on the CPU mesh and an operator checks
    against the real chip's datasheet capacity.

    An infeasible fleet (rho >= 1) reports ``queue_inflation=None``:
    the queue grows without bound and admission control (fleet queue
    cap + deadlines) turns the excess into load-shed results.
    """
    assert 0.0 < target_util < 1.0, target_util
    per = serving_roofline(
        cfg, batch=batch, context=context, tp=tp, chip=chip,
        **roofline_kw,
    )
    cap = per["tokens_per_sec"]
    offered = float(offered_tokens_per_sec)
    knee = int(max(1, -(-offered // (cap * target_util))))  # ceil
    rows = {}
    r = 1
    while r <= 2 * knee:
        rho = offered / (r * cap)
        rows[r] = {
            "utilization": rho,
            "queue_inflation": 1.0 / (1.0 - rho) if rho < 1 else None,
            "tokens_per_sec_capacity": r * cap,
        }
        r = r * 2 if r < knee // 2 else r + max(1, knee // 8)
    return {
        "per_replica_tokens_per_sec": cap,
        "per_replica_slots": batch,
        "offered_tokens_per_sec": offered,
        "target_util": target_util,
        "knee_replicas": knee,
        "replicas": rows,
    }


def llama_step_flops(cfg: dict, batch: int, seq_len: int | None = None,
                     remat: bool = True) -> float:
    """Training FLOPs per step: 6*P*tokens for the matmuls (fwd 2PT +
    bwd 4PT), +2PT when full remat recomputes the forward, plus the
    attention term 6 (or 8 with remat) * 2*B*H*T^2*hd (causal halves
    it)."""
    T = int(seq_len if seq_len is not None else cfg["seq_len"])
    P = llama_param_count(cfg)
    tokens = batch * T
    mult = 8.0 if remat else 6.0
    dense = mult * P * tokens
    attn = (
        (mult / 2.0)                      # causal: half the T^2 window
        * 2.0 * 2.0                       # QK^T and PV, 2 FLOPs/MAC
        * batch * int(cfg["n_heads"]) * T * T
        * (int(cfg["dim"]) // int(cfg["n_heads"]))
    )
    return dense + attn


# --------------------------------------------------------------------------
# MoE / expert parallelism (parallel/moe.py)
# --------------------------------------------------------------------------


def moe_param_count(cfg: dict) -> int:
    """Parameter count with every FFN a MoE (models/llama.py MoE
    layout): the dense count plus, per layer, the router [d, E] and
    the E-1 ADDITIONAL expert copies of gate/up/down (expert 1's copy
    is the dense FFN's own)."""
    d = int(cfg["dim"])
    L = int(cfg["n_layers"])
    f = int(cfg["ffn_dim"])
    e = int(cfg["n_experts"])
    return llama_param_count(cfg) + L * (d * e + 3 * (e - 1) * d * f)


def moe_alltoall_bytes(
    cfg: dict,
    *,
    batch_per_replica: int,
    ep: int,
    sp: int = 1,
    capacity_factor: float = 1.25,
    compute_bytes: int = 2,
) -> float:
    """Per-chip, per-step bytes the EP token exchange puts on the
    wire: each MoE layer runs 2 all_to_alls forward (dispatch + return
    of the [E, C, D] capacity buffers) and their 2 transposes in
    backward, each shipping the (ep-1)/ep remote fraction."""
    if ep <= 1:
        return 0.0
    from theanompi_tpu_torch.parallel.moe import moe_capacity

    d = int(cfg["dim"])
    L = int(cfg["n_layers"])
    e = int(cfg["n_experts"])
    k = int(cfg.get("moe_top_k", 2))
    n_loc = batch_per_replica * int(cfg["seq_len"]) // sp
    c = moe_capacity(n_loc, e, k, capacity_factor)
    rows = e * c
    return L * 4.0 * rows * d * compute_bytes * (ep - 1) / ep


def moe_ep_overhead(
    cfg: dict,
    *,
    batch_per_replica: int,
    ep: int,
    sp: int = 1,
    capacity_factor: float = 1.25,
    step_time_1chip: float,
    chip: ChipSpec = V5E,
    links: int | None = None,
) -> dict:
    """Zero-overlap bound on the EP all_to_all cost: exchange bytes
    over the chip's usable ICI egress vs the measured step time.
    XLA overlaps the dispatch of layer i with compute of layer i-1,
    so the truth sits between ``frac_of_step`` and 0 — same
    convention as ``bsp_efficiency``."""
    b = moe_alltoall_bytes(
        cfg, batch_per_replica=batch_per_replica, ep=ep, sp=sp,
        capacity_factor=capacity_factor,
    )
    links = ici_links_used(ep) if links is None else links
    t = b / (links * chip.ici_link_bw)
    return {
        "a2a_mb_per_step": b / 2**20,
        "t_a2a_ms": t * 1e3,
        "frac_of_step": t / step_time_1chip,
        "efficiency_no_overlap": step_time_1chip / (step_time_1chip + t),
    }


def llama_step_time(
    cfg: dict,
    *,
    batch: int,
    seq_len: int | None = None,
    mfu: float = 0.36,
    n_chips_compute: int = 1,
    chip: ChipSpec = V5E,
) -> float:
    """Predicted step seconds at a measured-on-this-hardware MFU
    (default: the Llama proxy MFU measured on a TPU v5e, 0.3608)."""
    fl = llama_step_flops(cfg, batch, seq_len)
    return fl / (mfu * chip.peak_bf16 * n_chips_compute)
