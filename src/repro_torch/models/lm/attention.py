"""Multi-head causal self-attention: GQA/MQA, qk-norm, QKV bias, RoPE.

The reference's ``repro/models/lm/attention.py`` for decoder-only stacks.
Prefill (``attention``) goes through the flash kernel's wrapper: on a CUDA
tensor it launches ``csrc/flash_attention.cu``, on a CPU tensor it runs the
kernel's plain version; the reference's ``chunked``/``xla``/``flash``
implementations compute that one function. Decode (``decode_attention``)
stays plain PyTorch on both devices, as the reference has no kernel there,
and writes the new token's K/V into the preallocated cache in place.

GQA grouping reshapes q to [B, S, KV, G, hd], so q-head ``h = kv·G + g`` reads
kv-head ``h // G``; K/V are never repeated in memory. Cross-attention and
``project_kv`` wait for the enc-dec family.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.lm.norm import rmsnorm, rmsnorm_init
from repro_torch.models.lm.rope import apply_rope

__all__ = ["attn_init", "attention", "decode_attention", "quantize_kv", "AttnStatics"]


def attn_init(make, d_model: int, num_heads: int, num_kv_heads: int, head_dim: int, *,
              qkv_bias: bool = False, qk_norm: bool = False, dtype=torch.bfloat16) -> Dict:
    """He-normal projections in the model dtype, zero biases, f32 qk-norm
    scales (``make``: a parameter maker of ``transformer.py``)."""
    hq, hk = num_heads * head_dim, num_kv_heads * head_dim
    p = {
        "wq": make.normal((d_model, hq), d_model**-0.5, dtype),
        "wk": make.normal((d_model, hk), d_model**-0.5, dtype),
        "wv": make.normal((d_model, hk), d_model**-0.5, dtype),
        "wo": make.normal((hq, d_model), hq**-0.5, dtype),
    }
    if qkv_bias:
        p["bq"] = make.zeros((hq,), dtype)
        p["bk"] = make.zeros((hk,), dtype)
        p["bv"] = make.zeros((hk,), dtype)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(make, head_dim)
        p["k_norm"] = rmsnorm_init(make, head_dim)
    return p


class AttnStatics:
    """Static knobs threaded through the transformer."""

    def __init__(self, num_heads: int, num_kv_heads: int, head_dim: int, *,
                 rope_theta: float = 1e4, qk_norm: bool = False, norm_eps: float = 1e-6,
                 use_rope: bool = True):
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.qk_norm = qk_norm
        self.norm_eps = norm_eps
        self.use_rope = use_rope


def _project_qkv(params: Dict, x: torch.Tensor, st: AttnStatics,
                 positions: Optional[torch.Tensor]):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, st.num_heads, st.head_dim)
    k = k.reshape(b, s, st.num_kv_heads, st.head_dim)
    v = v.reshape(b, s, st.num_kv_heads, st.head_dim)
    if st.qk_norm:
        q = rmsnorm(params["q_norm"], q, eps=st.norm_eps)
        k = rmsnorm(params["k_norm"], k, eps=st.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, st.rope_theta)
        k = apply_rope(k, positions, st.rope_theta)
    return q, k, v


def attention(params: Dict, x: torch.Tensor, st: AttnStatics,
              positions: Optional[torch.Tensor] = None, return_kv: bool = False):
    """Causal self-attention over the whole sequence (prefill / forward).

    x [B, S, D]. ``return_kv=True`` also returns this layer's k, v
    [B, S, KV, hd], so prefill fills the decode cache in the same pass."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, st, positions)
    out = fa_ops.flash_attention(q, k, v)  # the kernel on CUDA, its plain version on the CPU
    out = out.reshape(b, s, st.num_heads * st.head_dim) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def quantize_kv(k: torch.Tensor):
    """Per-(batch, position, kv-head) symmetric int8: k [B,S,KV,hd] ->
    (int8 of the same shape, f32 scale [B,S,KV])."""
    k32 = k.float()
    amax = torch.amax(torch.abs(k32), dim=-1)
    s = torch.clamp(amax / 127.0, min=1e-8)
    kq = torch.clamp(torch.round(k32 / s[..., None]), -127, 127)
    return kq.to(torch.int8), s


def decode_attention(params: Dict, x: torch.Tensor, st: AttnStatics,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: int,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None):
    """One decode step for x [B, 1, D]: write this token's K/V into the caches
    [B, L, KV, hd] at ``cache_len`` (in place), attend over the first
    ``cache_len + 1`` positions. Returns (out, k_cache, v_cache[, k_scale,
    v_scale]), the caches being the tensors passed in.

    With an int8 cache (f32 scales [B, L, KV]) dequantization folds into the
    einsums, as in the reference: the scores pick up the K scale, the f32
    probabilities the V scale. Positions past ``cache_len`` hold no token and
    are left out, where the reference masks them to -1e30 (weight exactly 0)."""
    b = x.shape[0]
    g = st.num_heads // st.num_kv_heads
    scale = 1.0 / math.sqrt(st.head_dim)
    pos = torch.full((b, 1), cache_len, dtype=torch.int64, device=x.device) if st.use_rope else None
    q, k, v = _project_qkv(params, x, st, pos)
    int8_cache = k_cache.dtype == torch.int8
    if int8_cache:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        k_scale[:, cache_len] = ks[:, 0]
        v_scale[:, cache_len] = vs[:, 0]
    k_cache[:, cache_len] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v[:, 0].to(v_cache.dtype)
    n = cache_len + 1
    kc, vc = k_cache[:, :n], v_cache[:, :n]
    qg = q.reshape(b, st.num_kv_heads, g, st.head_dim)
    if int8_cache:
        scores = torch.einsum("bkgh,btkh->bkgt", qg.float(), kc.float()) * scale
        scores = scores * k_scale[:, :n].transpose(1, 2)[:, :, None, :]
    else:
        scores = torch.einsum("bkgh,btkh->bkgt", qg, kc).float() * scale
    probs = torch.softmax(scores, dim=-1)
    if int8_cache:
        pv = probs * v_scale[:, :n].transpose(1, 2)[:, :, None, :]  # fold the V scale
        out = torch.einsum("bkgt,btkh->bkgh", pv, vc.float()).to(x.dtype)
    else:
        out = torch.einsum("bkgt,btkh->bkgh", probs.to(vc.dtype), vc)
    out = out.reshape(b, 1, st.num_heads * st.head_dim) @ params["wo"]
    if int8_cache:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache
