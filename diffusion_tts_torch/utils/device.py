"""Device selection for the port's entry points: the card by default, the
CPU only when the caller asks for it."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """``torch.device(device)``; raises when it names CUDA and no card is
    present, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
