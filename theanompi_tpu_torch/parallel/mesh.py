"""Device selection for the port.

The JAX package builds a mesh over ``default_devices()``; the port's
slice runs on one card, so device discovery reduces to choosing the
``torch.device`` every entry point places its tensors on.  The card is
the default: the CPU is used only when a caller asks for it, and a
missing card is an error rather than a quiet fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` unless told otherwise.  Raises when a CUDA device is
    wanted (the default) and none is present; ``device="cpu"`` is the
    only way onto the CPU.  Resolving a CUDA device also pins float32
    matrix products to full float32 (no TF32), the precision the JAX
    reference computes in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card "
                "by default; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
