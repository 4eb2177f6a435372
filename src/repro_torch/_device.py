"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device is never
    silently replaced by the CPU: asking for one without a visible card
    raises, so a run that reports device numbers really ran there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev
