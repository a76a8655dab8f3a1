"""The port's device rule: every device stage runs on an explicit torch
device, and asking for CUDA where there is none raises."""

from __future__ import annotations

import torch


def device_of(device) -> torch.device:
    """The torch device a decoder runs its device stages on.  Asking for
    CUDA where there is none raises; there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
