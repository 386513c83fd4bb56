"""Plain PyTorch version of the flash-attention kernel (``csrc/flash_attention.cu``).

The function of the TPU kernel ``repro/kernels/flash_attention/flash_attention.py``:
scores and probabilities in f32 (bf16 inputs are widened, so every product is
exact), with ``causal=True`` the causal mask aligned to the ends of both
sequences (no mask with ``causal=False``: the encoder and cross-attention),
the output cast to q's dtype. (The reference's own oracle, ``ref.py::attention_ref``, rounds
the probabilities to v's dtype before P.V; the kernel does not.) Holds the
``[B, KV, G, S, T]`` f32 scores whole: for tests, the CPU path, and to check
the kernel on the card.

``flash_attention_lse_ref`` also returns the row log-sum-exp the forward
kernels write for the backward, and ``flash_attention_bwd_ref`` is the plain
version of ``csrc/flash_attention_bwd.cu``: the gradient by the explicit
flash-attention formulas, from the forward's output and log-sum-exp.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
           "NEG_INF"]

NEG_INF = -1e30  # the TPU kernel's finite mask value


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The scaled, masked f32 scores [B, KV, G, S, T] (q-head h = kv·G + g)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill((kpos - (t - s)) > qpos, NEG_INF)
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,T,KV,hd] -> [B,S,H,hd]; causal end-aligned, or
    unmasked."""
    return _attend(q, k, v, causal, with_lse=False)[0]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True):
    """(out [B,S,H,hd] in q's dtype, lse [B,H,S] f32): lse is the natural-log
    ``logsumexp`` of each row's scaled, masked scores."""
    return _attend(q, k, v, causal, with_lse=True)


def _attend(q, k, v, causal: bool, with_lse: bool):
    b, s, h, hd = q.shape
    scores = _scores(q, k, causal)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    lse = torch.logsumexp(scores, dim=-1).reshape(b, h, s) if with_lse else None
    return out.reshape(b, s, h, hd).to(q.dtype), lse


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True):
    """(dq, dk, dv) in q's dtype for the upstream gradient ``dout``
    [B,S,H,hd], by the explicit formulas in f32: P = exp(s - lse),
    D = rowsum(dO ∘ O), dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP - D),
    dQ = scale · dS K, dK = scale · dSᵀ Q, dK and dV summed over the G
    q-heads of each kv-head."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    scores = _scores(q, k, causal)
    p = torch.exp(scores - lse.reshape(b, kv, g, s, 1))
    do = dout.float().reshape(b, s, kv, g, hd)
    d = (do * out.float().reshape(b, s, kv, g, hd)).sum(-1).permute(0, 2, 3, 1)  # [B,KV,G,S]
    dv = torch.einsum("bkgst,bskgh->btkh", p, do)
    dp = torch.einsum("bskgh,btkh->bkgst", do, v.float())
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, q.float().reshape(b, s, kv, g, hd)) * scale
    return dq.reshape(b, s, h, hd).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
