"""Plain PyTorch version of the SSD intra-chunk kernel (``csrc/ssd_scan.cu``),
the function of the reference's ``repro/kernels/ssd_scan/ref.py``."""
from __future__ import annotations

import torch

__all__ = ["ssd_intra_chunk_ref"]


def ssd_intra_chunk_ref(cc, bc, xdt, acum):
    """cc/bc [B,NC,Q,N]; xdt [B,NC,H,Q,P]; acum [B,NC,H,Q] -> [B,NC,H,Q,P]:
    ``((C Bᵀ) ∘ L) @ Xdt`` with ``L[i,j] = exp(a_i − a_j)·[i ≥ j]``."""
    q = cc.shape[2]
    li = acum[..., :, None] - acum[..., None, :]  # [B,NC,H,Q,Q]
    causal = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    lmat = torch.where(causal, torch.exp(li), torch.zeros((), device=cc.device))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,NC,Q,Q], shared by the heads
    return (cb[:, :, None] * lmat) @ xdt
