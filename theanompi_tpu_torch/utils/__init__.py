"""Checkpoint reading and serving telemetry for the port."""

from theanompi_tpu_torch.utils.recorder import Reservoir, ServingRecorder

__all__ = ["Reservoir", "ServingRecorder"]
