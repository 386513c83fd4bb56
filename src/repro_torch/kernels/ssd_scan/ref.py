"""Plain PyTorch versions of the SSD intra-chunk kernel (``csrc/ssd_scan.cu``),
the function of the reference's ``repro/kernels/ssd_scan/ref.py``, and of its
backward (``csrc/ssd_scan_bwd.cu``)."""
from __future__ import annotations

import torch

__all__ = ["ssd_intra_chunk_ref", "ssd_intra_chunk_bwd_ref"]


def ssd_intra_chunk_ref(cc, bc, xdt, acum):
    """cc/bc [B,NC,Q,N]; xdt [B,NC,H,Q,P]; acum [B,NC,H,Q] -> [B,NC,H,Q,P]:
    ``((C Bᵀ) ∘ L) @ Xdt`` with ``L[i,j] = exp(a_i − a_j)·[i ≥ j]``."""
    q = cc.shape[2]
    li = acum[..., :, None] - acum[..., None, :]  # [B,NC,H,Q,Q]
    causal = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    lmat = torch.where(causal, torch.exp(li), torch.zeros((), device=cc.device))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,NC,Q,Q], shared by the heads
    return (cb[:, :, None] * lmat) @ xdt


def ssd_intra_chunk_bwd_ref(cc, bc, xdt, acum, dy):
    """The gradient of ``ssd_intra_chunk_ref`` for the upstream gradient ``dy``
    [B,NC,H,Q,P]: (dcc, dbc, dxdt, dacum), from the formulas, not autograd.

    With ``W_h = (C Bᵀ) ∘ L_h``: ``dXdt_h = W_hᵀ dY_h``; ``dW_h = dY_h Xdt_hᵀ``
    on ``i ≥ j``; ``dCB = Σ_h dW_h ∘ L_h`` (one C, B group shared by the
    heads); ``dC = dCB B``, ``dB = dCBᵀ C``; with ``G_h = dW_h ∘ W_h``,
    ``dacum_h[i] = Σ_j G_h[i,j] − Σ_k G_h[k,i]``. The decay is one
    ``exp(a_i − a_j)`` per pair ``i ≥ j`` (the other pairs are exp(−inf)),
    never ``exp(a_i)·exp(−a_j)``, which overflows."""
    q = cc.shape[2]
    causal = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    li = acum[..., :, None] - acum[..., None, :]
    lmat = torch.exp(torch.where(causal, li, torch.full((), -torch.inf, device=cc.device)))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    w = cb[:, :, None] * lmat  # [B,NC,H,Q,Q]
    dxdt = w.transpose(-1, -2) @ dy
    dw = torch.where(causal, dy @ xdt.transpose(-1, -2), torch.zeros((), device=cc.device))
    dcb = (dw * lmat).sum(2)  # [B,NC,Q,Q]
    dcc = dcb @ bc
    dbc = dcb.transpose(-1, -2) @ cc
    g = dw * w
    dacum = g.sum(-1) - g.sum(-2)
    return dcc, dbc, dxdt, dacum
