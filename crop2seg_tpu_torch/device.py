"""Device resolution for the port's entry points (the CUDA card by default)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device. Raises when CUDA is asked for
    (explicitly or by default) but absent: an entry point never carries on
    silently on the CPU; the caller passes ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
