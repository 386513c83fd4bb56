"""Plain PyTorch version of the flash-attention kernel (``csrc/flash_attention.cu``).

The function of the TPU kernel ``repro/kernels/flash_attention/flash_attention.py``:
scores and probabilities in f32 (bf16 inputs are widened, so every product is
exact), the causal mask aligned to the ends of both sequences, the output cast
to q's dtype. (The reference's own oracle, ``ref.py::attention_ref``, rounds
the probabilities to v's dtype before P.V; the kernel does not.) Holds the
``[B, KV, G, S, T]`` f32 scores whole: for tests, the CPU path, and to check
the kernel on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30  # the TPU kernel's finite mask value


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,T,KV,hd] -> [B,S,H,hd]; causal, end-aligned."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (1.0 / math.sqrt(hd))
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    scores = scores.masked_fill((kpos - (t - s)) > qpos, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
