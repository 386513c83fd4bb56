"""Where the port's entry points run: ``cuda`` unless the caller says ``cpu``."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and there is none.

    The port never carries on on the CPU when a card was asked for: the CPU
    runs the kernels' plain versions, which are for tests, not for serving.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available, and the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions of the "
            "kernels on the CPU"
        )
    return dev
