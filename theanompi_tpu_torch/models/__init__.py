"""Models of the port: Llama (serving and BSP training)."""

from theanompi_tpu_torch.models.llama import (
    LLAMA3_8B,
    Llama,
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)

__all__ = ["LLAMA3_8B", "Llama", "opt_state_from_jax", "opt_state_to_jax",
           "params_from_jax", "params_to_jax"]
