"""Models of the port: Llama (serving subset)."""

from theanompi_tpu_torch.models.llama import (
    LLAMA3_8B,
    Llama,
    params_from_jax,
    params_to_jax,
)

__all__ = ["LLAMA3_8B", "Llama", "params_from_jax", "params_to_jax"]
