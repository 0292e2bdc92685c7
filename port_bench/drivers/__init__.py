"""The general drivers a traffic mix names by its ``driver`` key: one
for training, one for serving.  Each takes a :class:`Run` and returns
its :class:`Outcome`."""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The allocator's peak on the card since the process started (0 on
    the CPU, which has no such reading)."""
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


@dataclass
class Run:
    """What ``run.py`` hands a driver."""

    cell: object           # spec.Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float         # time.monotonic() at process start
    device: object         # torch.device


@dataclass
class Outcome:
    """What a driver returns: the end-to-end values (``--trace 0``) or
    the records the per-layer readers take (``--trace 1``), the
    comparison, the counts and the device readings."""

    end_to_end: dict = field(default_factory=dict)
    records: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    #: what the reference judged (serving: the sampled prompts and
    #: their served tokens; training: the port's and the reference's
    #: losses and leaf norms), for the calibration of the limits
    judged: list | None = None
