"""LR schedules: linear warmup + cosine decay (pure functions of step), as
the reference's ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """lr(step): linear 0→peak over `warmup`, cosine peak→floor·peak by `total`."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
