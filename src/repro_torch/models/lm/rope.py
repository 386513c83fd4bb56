"""Rotary position embeddings: standard RoPE and M-RoPE (Qwen2-VL), the
reference's ``repro/models/lm/rope.py``.

M-RoPE splits each head's rotary frequencies into (temporal, height, width)
sections and rotates each section by its own position stream; plain text
uses identical t/h/w positions, images advance h/w per patch. The backbone
receives the three streams from the (stubbed) modality frontend.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_frequencies", "apply_rope", "apply_mrope", "mrope_text_positions"]


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """x [B, S, H, hd], positions int[3, B, S] (t, h, w streams): the first
    ``sections[0]`` frequencies follow the temporal stream, the next
    ``sections[1]`` the height stream, the last the width stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to hd/2 = {half}")
    inv = rope_frequencies(x.shape[-1], theta, device=x.device)  # [half]
    parts, off = [], 0
    for sec, pos in zip(sections, positions):
        parts.append(pos[..., None].float() * inv[off:off + sec])  # [B, S, sec]
        off += sec
    angles = torch.cat(parts, dim=-1)  # [B, S, half]
    return _rotate(x, angles[:, :, None, :])


def mrope_text_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """Pure-text M-RoPE: three identical streams, int32[3, B, S]."""
    p = torch.arange(seq, dtype=torch.int32, device=device)
    return p[None, None].expand(3, batch, seq)
