"""Load-time int8 weight relayout for the int8 matmul kernel.

The kernel reads the weight one output column at a time along K, 16 bytes per
load, so the weight is rewritten once, when the engine first quantizes it:

    int8[K, N]  ->  int8[N, Kp]   (transposed, K zero-padded to Kp = ⌈K/16⌉·16)

The engine caches the result per weight (``AmpleEngine._weight_q``), as the
reference caches its TPU tile relayout; every later matmul on that weight
skips straight to the kernel. Padding with zeros leaves the product unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["RepackedWeight", "repack_weight", "unpack_weight", "K_ALIGN"]

K_ALIGN = 16  # bytes: one 16-byte load per column and K step


class RepackedWeight(NamedTuple):
    """A weight laid out as the int8 matmul kernel reads it."""

    w_nk: torch.Tensor  # int8[N, Kp], K contiguous, zeros past k
    k: int  # true (unpadded) K
    n: int  # N


def repack_weight(w_q: torch.Tensor) -> RepackedWeight:
    """One-time relayout of an int8[K, N] weight into int8[N, Kp]."""
    if w_q.dim() != 2 or w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8[K, N], got {w_q.dtype}{tuple(w_q.shape)}")
    k, n = w_q.shape
    kp = -(-k // K_ALIGN) * K_ALIGN
    w_nk = torch.zeros((n, kp), dtype=torch.int8, device=w_q.device)
    w_nk[:, :k] = w_q.t()
    return RepackedWeight(w_nk=w_nk, k=int(k), n=int(n))


def unpack_weight(packed: RepackedWeight) -> torch.Tensor:
    """The int8[K, N] weight a ``RepackedWeight`` holds (a view)."""
    return packed.w_nk[:, : packed.k].t()
