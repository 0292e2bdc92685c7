"""Exchange-strategy registry (port of
``theanompi_tpu/parallel/strategies.py``).

The reference's config names map to (wire dtype x collective shape):

=========  ==========  =====================================
name       wire dtype  collectives
=========  ==========  =====================================
ar         fp32        all_reduce
asa32      fp32        reduce_scatter + all_gather
asa16      bf16        reduce_scatter + all_gather
nccl32     fp32        all_reduce
nccl16     bf16        all_reduce
ici32      fp32        all_reduce (the JAX package's default name)
ici16      bf16        all_reduce
=========  ==========  =====================================

The ZeRO-1 strategies (``zero1``, ``zero1_16``) and the compressed
wire (``exch_compression`` int8/fp8) are not ported yet: asking for
them raises ``NotImplementedError`` naming ROADMAP A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from theanompi_tpu_torch.parallel.exchange import allreduce_mean


@dataclasses.dataclass(frozen=True)
class ExchangeStrategy:
    """A named allreduce flavor: wire dtype + collective shape."""

    name: str
    wire_dtype: Optional[Any]        # None = native dtype on the wire
    two_phase: bool                  # reduce_scatter+all_gather vs all_reduce

    def __call__(self, tensors, group=None, bucket_elems: int = 0) -> None:
        allreduce_mean(tensors, group=group, wire_dtype=self.wire_dtype,
                       two_phase=self.two_phase, bucket_elems=bucket_elems)

    def bucket_elems(self, bucket_mb: float) -> int:
        """``exchange_bucket_mb`` -> elements of the fp32 master-width
        exchange buffer per bucket (0 stays 0 = monolithic)."""
        if not bucket_mb:
            return 0
        return max(1, int(float(bucket_mb) * 2**20 / 4))


STRATEGIES: dict[str, ExchangeStrategy] = {
    s.name: s
    for s in (
        ExchangeStrategy("ar", None, False),
        ExchangeStrategy("asa32", None, True),
        ExchangeStrategy("asa16", torch.bfloat16, True),
        ExchangeStrategy("nccl32", None, False),
        ExchangeStrategy("nccl16", torch.bfloat16, False),
        ExchangeStrategy("ici32", None, False),
        ExchangeStrategy("ici16", torch.bfloat16, False),
    )
}

#: named in the JAX package, not ported yet (ROADMAP A8)
UNPORTED = ("zero1", "zero1_16")

# exchange_bucket_mb default: DDP-style ~4 MiB buckets; 0 = monolithic
DEFAULT_BUCKET_MB = 4.0


def resolve_bucket_mb(config: dict | None) -> float:
    """The ``exchange_bucket_mb`` config knob, validated: None/0 ->
    0.0 (monolithic), unset -> ``DEFAULT_BUCKET_MB``."""
    mb = float((config or {}).get(
        "exchange_bucket_mb", DEFAULT_BUCKET_MB) or 0)
    if mb < 0:
        raise ValueError(
            f"exchange_bucket_mb must be >= 0 (0 = monolithic "
            f"exchange), got {mb}"
        )
    return mb


COMPRESSION_CHOICES = ("none", "int8", "fp8")


def resolve_compression(config: dict | None) -> None:
    """The ``exch_compression`` knob: only ``"none"`` runs in the port."""
    comp = (config or {}).get("exch_compression", "none") or "none"
    if comp not in COMPRESSION_CHOICES:
        raise ValueError(
            f"unknown exch_compression {comp!r}; known: "
            f"{COMPRESSION_CHOICES}"
        )
    if comp != "none":
        raise NotImplementedError(
            f"exch_compression={comp!r} is not ported yet (ROADMAP.md "
            f"A8: the quantized wire with error feedback)"
        )


def get_strategy(name: str) -> ExchangeStrategy:
    if name in UNPORTED:
        raise NotImplementedError(
            f"exch_strategy {name!r} is not ported yet (ROADMAP.md A8: "
            f"ZeRO-1 sharded optimizer state)"
        )
    try:
        return STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown exch_strategy {name!r}; known: "
            f"{sorted(STRATEGIES) + list(UNPORTED)}"
        ) from None
