"""Ops of the port: attention (kernel K1 and its plain version)."""

from theanompi_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention,
    flash_attention_fwd,
    mha_reference,
)

__all__ = ["NEG_INF", "flash_attention", "flash_attention_fwd",
           "mha_reference"]
