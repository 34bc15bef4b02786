"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``: the port is written for the
card, and a missing card is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device=\"cpu\" explicitly to run the plain versions")
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array / tensor -> tensor on ``device`` (no copy when already
    there)."""
    return torch.as_tensor(x).to(device=device, dtype=dtype)
