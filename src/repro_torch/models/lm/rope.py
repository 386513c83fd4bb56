"""Rotary position embeddings (the reference's ``repro/models/lm/rope.py``;
M-RoPE waits for the VLM family)."""
from __future__ import annotations

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """f32[head_dim/2] inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) by ``angles`` [..., half];
    cos and sin are cast to x's dtype before they multiply, as in the
    reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd], positions int[B, S]."""
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., None].float() * inv  # [B, S, hd/2]
    return _rotate(x, angles[:, :, None, :])
