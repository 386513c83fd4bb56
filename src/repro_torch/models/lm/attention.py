"""Multi-head attention: GQA/MQA, qk-norm, QKV bias, RoPE/M-RoPE, causal
self-attention, unmasked self-attention (an encoder) and cross-attention.

The reference's ``repro/models/lm/attention.py``. Every full-sequence
attention (``attention``) goes through the flash kernel's wrapper: on a CUDA
tensor it launches ``csrc/flash_attention.cu``, on a CPU tensor it runs the
kernel's plain version. Causal self-attention calls it with ``causal=True``;
an encoder (``st.causal`` False) and cross-attention (``kv`` given) with
``causal=False``. The reference's ``chunked``/``xla``/``flash``
implementations compute that one function in each case. Decode
(``decode_attention``) stays plain PyTorch on both devices, as the reference
has no kernel there, and writes the new token's K/V into the preallocated
cache in place.

GQA grouping reshapes q to [B, S, KV, G, hd], so q-head ``h = kv·G + g`` reads
kv-head ``h // G``; K/V are never repeated in memory.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import all_reduce, on_mesh
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.lm.norm import rmsnorm, rmsnorm_init
from repro_torch.models.lm.rope import apply_mrope, apply_rope

__all__ = ["attn_init", "attention", "project_kv", "project_kv_sharded", "decode_attention",
           "cross_decode_attention", "quantize_kv", "AttnStatics"]


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
                 rope_theta: float = 1e4, mrope: bool = False,
                 mrope_sections: Tuple[int, int, int] = (16, 24, 24), qk_norm: bool = False,
                 causal: bool = True, norm_eps: float = 1e-6, use_rope: bool = True):
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.mrope = mrope
        self.mrope_sections = mrope_sections
        self.qk_norm = qk_norm
        self.causal = causal
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
        if st.mrope:  # positions [3, B, S]
            q = apply_mrope(q, positions, st.rope_theta, st.mrope_sections)
            k = apply_mrope(k, positions, st.rope_theta, st.mrope_sections)
        else:
            q = apply_rope(q, positions, st.rope_theta)
            k = apply_rope(k, positions, st.rope_theta)
    return q, k, v


def attention(params: Dict, x: torch.Tensor, st: AttnStatics,
              positions: Optional[torch.Tensor] = None,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, return_kv: bool = False,
              policy=None, kv_spec=None):
    """Full-sequence attention (prefill / forward / encoder / cross).

    x [B, S, D]. Self-attention projects q, k, v from x, causal when
    ``st.causal``. With ``kv`` = (k, v) [B, T, KV, hd] (``project_kv`` of an
    encoder's output) it is cross-attention, unmasked: q is ``x @ wq``
    without ``bq``, then q's qk-norm, as in the reference. ``return_kv=True``
    also returns this layer's k, v, so prefill fills the decode cache in the
    same pass. Under a mesh ``policy`` see ``_attention_sharded`` (``kv_spec``:
    the layout of a cross-attention's K/V there)."""
    if on_mesh(policy):
        return _attention_sharded(params, x, st, positions, return_kv, policy, kv, kv_spec)
    b, s, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(params, x, st, positions)
    else:
        q = (x @ params["wq"]).reshape(b, s, st.num_heads, st.head_dim)
        if st.qk_norm:
            q = rmsnorm(params["q_norm"], q, eps=st.norm_eps)
        k, v = kv
    causal = st.causal and kv is None
    # the kernel on CUDA, its plain version on the CPU
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    out = out.reshape(b, s, st.num_heads * st.head_dim) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def project_kv(params: Dict, x: torch.Tensor, st: AttnStatics):
    """K/V projection alone (the cross-attention source, computed once from
    an encoder's output x [B, T, D]): (k, v) [B, T, KV, hd], contiguous."""
    b, t, _ = x.shape
    k = (x @ params["wk"]).reshape(b, t, st.num_kv_heads, st.head_dim)
    v = (x @ params["wv"]).reshape(b, t, st.num_kv_heads, st.head_dim)
    if "bk" in params:
        k = k + params["bk"].reshape(st.num_kv_heads, st.head_dim)
        v = v + params["bv"].reshape(st.num_kv_heads, st.head_dim)
    if st.qk_norm:
        k = rmsnorm(params["k_norm"], k, eps=st.norm_eps)
    return k, v


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
                     v_scale: Optional[torch.Tensor] = None, policy=None):
    """One decode step for x [B, 1, D]: write this token's K/V into the caches
    [B, L, KV, hd] at ``cache_len`` (in place), attend over the first
    ``cache_len + 1`` positions. Returns (out, k_cache, v_cache[, k_scale,
    v_scale]), the caches being the tensors passed in.

    With an int8 cache (f32 scales [B, L, KV]) dequantization folds into the
    einsums, as in the reference: the scores pick up the K scale, the f32
    probabilities the V scale. Positions past ``cache_len`` hold no token and
    are left out, where the reference masks them to -1e30 (weight exactly 0).
    Under a mesh ``policy`` see ``_decode_attention_sharded``."""
    if on_mesh(policy):
        return _decode_attention_sharded(params, x, st, k_cache, v_cache, cache_len, policy,
                                         k_scale, v_scale)
    b = x.shape[0]
    g = st.num_heads // st.num_kv_heads
    scale = 1.0 / math.sqrt(st.head_dim)
    # M-RoPE gives all three streams the position cache_len, as the reference does.
    shape = (3, b, 1) if st.mrope else (b, 1)
    pos = torch.full(shape, cache_len, dtype=torch.int64, device=x.device) if st.use_rope else None
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


# ------------------------------------------------------------- on a mesh
def _local_heads(params: Dict, st: AttnStatics, policy):
    """(params, statics, head-parallel): in ``tp`` with the heads split over
    "model" (H and KV divisible, the projections column-sharded) each rank
    projects its own heads; otherwise every model-sharded leaf is gathered
    and the heads stay whole (fsdp shards no leaf over "model" after its
    FSDP gather)."""
    tp = policy.tp
    hq, hk = st.num_heads * st.head_dim, st.num_kv_heads * st.head_dim
    split = params["wq"].shape[-1] != hq
    if (policy.mode == "tp" and split and st.num_heads % tp == 0 and st.num_kv_heads % tp == 0
            and params["wk"].shape[-1] * tp == hk):
        p = dict(params)
        for name in ("q_norm", "k_norm"):  # applied to this rank's heads only
            if name in p:
                p[name] = {k: policy.colpar(v) for k, v in p[name].items()}
        local = AttnStatics(st.num_heads // tp, st.num_kv_heads // tp, st.head_dim,
                            rope_theta=st.rope_theta, mrope=st.mrope,
                            mrope_sections=st.mrope_sections, qk_norm=st.qk_norm,
                            causal=st.causal, norm_eps=st.norm_eps, use_rope=st.use_rope)
        return p, local, True
    full = {"wq": (-1, hq), "wk": (-1, hk), "wv": (-1, hk), "wo": (0, hq), "bq": (0, hq),
            "bk": (0, hk), "bv": (0, hk)}
    p = dict(params)
    for name, (dim, n) in full.items():
        if name in p and p[name].shape[dim] != n:
            p[name] = policy.gather_model(p[name], dim % p[name].dim())
    return p, st, False


def _attention_sharded(params: Dict, x: torch.Tensor, st: AttnStatics,
                       positions: Optional[torch.Tensor], return_kv: bool, policy,
                       kv=None, kv_spec=None):
    """Full-sequence attention on a mesh. x [B', S', D] in the block's
    compute layout (``policy.compute_spec()``), positions in the same.
    Head-parallel (``tp``): q/k/v of this rank's heads, then the ``qkv``
    hook moves q to its sequence rows ``[a, a + S/tp)`` with every head (one
    all-to-all) and gathers K/V, cut, when causal, to the first ``a + S/tp``
    positions; flash runs on that local problem unchanged (its causal mask
    ``kpos - (T - S) > qpos`` is the global one; an encoder's is none); the
    output moves back to this rank's heads and ``wo`` reduces over "model".
    Cross-attention (``kv`` given, ``project_kv_sharded``'s K/V in the
    layout ``kv_spec``): q is ``x @ wq`` without ``bq``, split over the
    decoder's rows the same way, against every encoder position, unmasked.
    Returns the output in the compute layout and, with ``return_kv``
    (prefill), k and v of every position and head [B'', S, KV, hd], batch
    over the data axes: what the cache's shards are cut from."""
    b, s, _ = x.shape
    p, lst, hp = _local_heads(params, st, policy)
    compute = policy.compute_spec()
    src = (compute[0], compute[1], ("model",) if hp else (), ())
    xin = policy.colpar(x) if hp else x
    if kv is None:
        q, k, v = _project_qkv(p, xin, lst, positions)
    else:
        q = (xin @ p["wq"]).reshape(b, s, lst.num_heads, lst.head_dim)
        if lst.qk_norm:
            q = rmsnorm(p["q_norm"], q, eps=lst.norm_eps)
        k, v = kv
    causal = st.causal and kv is None
    qd, kd, vd = policy.qkv(q, k, v, src, causal=causal, kv_src=kv_spec)
    out = fa_ops.flash_attention(qd, kd, vd, causal=causal)
    out = policy.redistribute(out, policy.q_spec(), src).reshape(b, s, -1) @ p["wo"]
    if hp:
        out = policy.rowpar(out)
    if return_kv:
        whole = (tuple(a for a in compute[0] if a != "model"), (), (), ())
        with torch.no_grad():
            k, v = (policy.redistribute(t, src, whole) for t in (k, v))
        return out, k, v
    return out


def project_kv_sharded(params: Dict, x: torch.Tensor, st: AttnStatics, policy):
    """``project_kv`` on a mesh, from x [B', T', D] in the (encoder's)
    compute layout: (k, v, their layout) — this rank's heads when
    head-parallel (``colpar(x)``: every rank's heads read x), else every
    head."""
    p, lst, hp = _local_heads(params, st, policy)
    compute = policy.compute_spec()
    k, v = project_kv(p, policy.colpar(x) if hp else x, lst)
    return k, v, (compute[0], compute[1], ("model",) if hp else (), ())


def _combine(qg: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, scale: float, policy,
             k_scale=None, v_scale=None, dtype=None) -> torch.Tensor:
    """Attention of one query row per batch row, qg [B, KV, G, hd], over this
    rank's positions kc, vc [B, n, KV, hd] (n may be 0) of keys split over
    "model": the softmax combined by a max and a sum all-reduce, then the
    probability-weighted V by a sum. An int8 cache folds its scales [B, n,
    KV] in as on one device: the K scale into the scores, the V scale into
    the f32 probabilities. Returns [B, KV, G, hd] in ``dtype``."""
    model = policy.group("model")
    if k_scale is not None:
        scores = torch.einsum("bkgh,btkh->bkgt", qg.float(), kc.float()) * scale
        scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    else:
        scores = torch.einsum("bkgh,btkh->bkgt", qg, kc).float() * scale
    m_loc = (scores.amax(-1) if kc.shape[1] else
             torch.full(scores.shape[:-1], float("-inf"), device=qg.device))
    m = all_reduce(m_loc, model, op="max")
    e = torch.exp(scores - m[..., None])
    probs = e / all_reduce(e.sum(-1), model)[..., None]
    if v_scale is not None:
        pv = probs * v_scale.transpose(1, 2)[:, :, None, :]
        return all_reduce(torch.einsum("bkgt,btkh->bkgh", pv, vc.float()), model).to(dtype)
    return all_reduce(torch.einsum("bkgt,btkh->bkgh", probs.to(vc.dtype), vc), model)


@torch.no_grad()
def _decode_attention_sharded(params: Dict, x: torch.Tensor, st: AttnStatics,
                              k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len: int,
                              policy, k_scale=None, v_scale=None, cross: bool = False):
    """One decode step on a mesh. The local caches [B', L/tp, KV, hd] hold
    this rank's positions ``[m·L/tp, (m+1)·L/tp)`` of its batch rows, every
    head (``cache_shardings``). q and the new k, v are gathered to every
    head; the new token's K/V (int8 with its scales, quantized per position
    and kv-head as on one device) go to the rank that holds ``cache_len``;
    each rank scores its own valid positions and ``_combine`` adds them up.
    ``cross``: the caches are a cross-attention's encoder positions, all
    valid (no causal limit), q without ``bq``, nothing written. Returns
    (out in the compute layout, k_cache, v_cache[, k_scale, v_scale])."""
    b = x.shape[0]
    p, lst, hp = _local_heads(params, st, policy)
    compute = policy.compute_spec()
    src = (compute[0], (), ("model",) if hp else (), ())
    dst = ((tuple(a for a in compute[0] if a != "model")), (), (), ())
    l_loc = k_cache.shape[1]
    if cross:
        q = (x @ p["wq"]).reshape(b, 1, lst.num_heads, lst.head_dim)
        if lst.qk_norm:
            q = rmsnorm(p["q_norm"], q, eps=lst.norm_eps)
        q = policy.redistribute(q, src, dst)
        n = l_loc
    else:
        shape = (3, b, 1) if st.mrope else (b, 1)
        pos = (torch.full(shape, cache_len, dtype=torch.int64, device=x.device)
               if st.use_rope else None)
        q, k, v = _project_qkv(p, x, lst, pos)
        q, k, v = (policy.redistribute(t, src, dst) for t in (q, k, v))
        lo = policy._coord("model") * l_loc
        if lo <= cache_len < lo + l_loc:
            if k_scale is not None:
                (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
                k_scale[:, cache_len - lo], v_scale[:, cache_len - lo] = ks[:, 0], vs[:, 0]
            k_cache[:, cache_len - lo] = k[:, 0].to(k_cache.dtype)
            v_cache[:, cache_len - lo] = v[:, 0].to(v_cache.dtype)
        n = max(0, min(l_loc, cache_len + 1 - lo))
    bq = q.shape[0]
    g = st.num_heads // st.num_kv_heads
    qg = q.reshape(bq, st.num_kv_heads, g, st.head_dim)
    scales = {} if k_scale is None else dict(k_scale=k_scale[:, :n], v_scale=v_scale[:, :n])
    out = _combine(qg, k_cache[:, :n], v_cache[:, :n], 1.0 / math.sqrt(st.head_dim), policy,
                   dtype=x.dtype, **scales)
    out = out.reshape(bq, 1, st.num_heads, st.head_dim)
    if hp:  # this rank's heads into its rows of wo, then the row-parallel sum
        out = policy.take(out, ((), (), ("model",)))
        out = policy.rowpar(out.reshape(bq, 1, -1) @ p["wo"])
    else:
        out = out.reshape(bq, 1, -1) @ p["wo"]
    out = policy.redistribute(out, (dst[0], (), ()), compute)
    if k_scale is not None:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache


def cross_decode_attention(params: Dict, x: torch.Tensor, st: AttnStatics, k: torch.Tensor,
                           v: torch.Tensor, policy) -> torch.Tensor:
    """A decode step's cross-attention on a mesh: x [B', 1, D] in the
    compute layout against a cross cache [B'', T/tp, KV, hd] cut over the
    encoder positions (``cache_shardings``), combined over those shards
    with no causal limit."""
    return _decode_attention_sharded(params, x, st, k, v, 0, policy, cross=True)[0]
