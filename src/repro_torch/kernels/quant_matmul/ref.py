"""Plain PyTorch version of the int8 matmul kernel (``csrc/quant_matmul.cu``)."""
from __future__ import annotations

import torch

__all__ = ["quant_matmul_ref"]


def quant_matmul_ref(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int32[M, N] = a_q @ b_q, exact integer accumulation.

    On the CPU the product is taken in int32. CUDA has no integer matmul, so
    there it is taken in float64, which is exact: every partial sum is an
    integer below 2^31 < 2^53.
    """
    if a_q.device.type == "cpu":
        return a_q.to(torch.int32) @ b_q.to(torch.int32)
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)
