"""Wrappers of the int8 matmul kernel (the int8 FTE stream).

A CUDA tensor launches ``csrc/quant_matmul.cu``; a CPU tensor takes the plain
version (``ref.py``). Both give bitwise the same int32 result. The kernel
reads int8 codes, which carry no gradient; the gradient of the int8 FTE
reaches the scales through its dequant (``core/transformation.py``, and the
streamed FTE's in ``memory/prefetcher.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kernels.quant_matmul.repack import (
    K_ALIGN,
    RepackedWeight,
    repack_weight,
    unpack_weight,
)

__all__ = [
    "KERNEL",
    "quant_matmul",
    "quant_matmul_repacked",
    "repack_weight",
    "RepackedWeight",
]

KERNEL = "quant_matmul"


def quant_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int32[M, N] = int8[M, K] @ int8[K, N].

    On the card the weight is relaid for this one call; callers that reuse a
    weight relayout it once with ``repack_weight`` and call
    ``quant_matmul_repacked``.
    """
    if a_q.device.type == "cpu":
        return quant_matmul_ref(a_q, b_q)
    return quant_matmul_repacked(a_q, repack_weight(b_q))


def quant_matmul_repacked(a_q: torch.Tensor, packed: RepackedWeight) -> torch.Tensor:
    """int32[M, N] = a_q @ W from the relaid weight; bitwise == ``quant_matmul``."""
    if a_q.dim() != 2 or a_q.shape[1] != packed.k:
        raise ValueError(
            f"activation must be [M, {packed.k}] to match the repacked weight, "
            f"got {tuple(a_q.shape)}"
        )
    if a_q.device.type == "cpu":
        return quant_matmul_ref(a_q, unpack_weight(packed))
    if a_q.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for device {a_q.device}")
    w = packed.w_nk
    m, k = a_q.shape
    n, kp = w.shape
    if a_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {a_q.dtype} and {w.dtype}")
    if w.device != a_q.device:
        raise ValueError(f"weight is on {w.device}, activation on {a_q.device}")
    if not (a_q.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8 matmul operands must be contiguous")
    if n != packed.n or kp % K_ALIGN or kp < k or w.data_ptr() % K_ALIGN:
        raise ValueError(
            f"repacked weight must be int8[{packed.n}, Kp] with Kp >= {k}, a "
            f"multiple of {K_ALIGN}, {K_ALIGN}-byte aligned; got {tuple(w.shape)}"
        )
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    if m == 0 or n == 0:
        return out
    build.call(
        "ample_quant_matmul", a_q.device,
        a_q.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, kp,
    )
    build.count_launch(KERNEL)
    return out
