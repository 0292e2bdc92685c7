"""Checkpoints and telemetry for the port."""

from theanompi_tpu_torch.utils.recorder import (
    FleetRecorder,
    Recorder,
    Reservoir,
    ServingRecorder,
)

__all__ = ["FleetRecorder", "Recorder", "Reservoir", "ServingRecorder"]
