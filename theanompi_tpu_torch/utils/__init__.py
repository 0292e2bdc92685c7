"""Checkpoints and telemetry for the port."""

from theanompi_tpu_torch.utils.recorder import (
    Recorder,
    Reservoir,
    ServingRecorder,
)

__all__ = ["Recorder", "Reservoir", "ServingRecorder"]
