"""Data modules of the port (numpy only, copied from the JAX
package)."""

from theanompi_tpu_torch.models.data.lm_synthetic import MarkovLMData

__all__ = ["MarkovLMData"]
