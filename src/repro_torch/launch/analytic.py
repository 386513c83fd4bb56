"""Analytic FLOP and byte models per (arch × shape), the reference's
``repro/launch/analytic.py``: closed forms that follow the products of
``models/lm/*`` and read only the config and ``block_roles``.

* ``step_flops``: global FLOPs of one step (train: forward + backward, ×3,
  and ×4 under ``remat="block"``, which recomputes the forward);
* ``model_flops``: the 6·N·D (dense) / 6·N_active·D (MoE) reference;
* ``step_hbm_bytes``: per-device device-memory traffic (weight streams,
  activations read and written, KV-cache reads and writes).

The SSD's intra-chunk term is in ``_mamba_flops`` (``2·t·Q·(N + H·P)``: the
quadratic C Bᵀ and the weighted Xdt product), which 6·N·D leaves out.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.lm.transformer import block_roles

__all__ = ["analytic_report", "step_flops", "model_flops", "step_hbm_bytes"]

def _attn_flops(cfg, t_q: int, t_kv: int) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * t_q * d * (h * hd) + 2 * t_q * d * (2 * kv * hd) + 2 * t_q * (h * hd) * d
    core = 2 * 2 * t_q * t_kv * h * hd  # scores + AV
    return proj + core


def _mlp_flops(cfg, t: int, f: int) -> float:
    mats = 3 if cfg.mlp == "swiglu" else 2
    return 2 * t * cfg.d_model * f * mats


def _moe_flops(cfg, t: int) -> float:
    # capacity-padded routed compute + router + optional shared expert
    routed = _mlp_flops(cfg, int(t * cfg.experts_per_token * cfg.capacity_factor), cfg.d_ff)
    router = 2 * t * cfg.d_model * cfg.num_experts
    shared = _mlp_flops(cfg, t, cfg.d_ff) if cfg.moe_shared_expert else 0
    return routed + router + shared


def _mamba_flops(cfg, t: int) -> float:
    d, di, n, h, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    q = cfg.ssm_chunk
    proj = 2 * t * d * (2 * di + 2 * n + h) + 2 * t * di * d
    conv = 2 * t * (di + 2 * n) * cfg.ssm_conv
    ssd = 2 * t * (q * n + q * h * p + 2 * h * p * n)  # cb, y_diag, states+y_off
    return proj + conv + ssd


def _mamba_decode_flops(cfg, b: int) -> float:
    d, di, n, h, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = 2 * b * d * (2 * di + 2 * n + h) + 2 * b * di * d
    state = 2 * 2 * b * h * p * n
    return proj + state


def _roles(cfg: ModelConfig):
    return block_roles(cfg) if cfg.family != "audio" else [("attn", "dense")]


def step_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global FLOPs of one step of ``shape.kind`` on ``shape``'s batch."""
    b, s = shape.global_batch, shape.seq_len
    roles = _roles(cfg)
    units = cfg.num_layers // len(roles) if cfg.family != "audio" else cfg.num_layers

    def stack_flops(t_q, t_kv, causal_frac=1.0):
        total = 0.0
        for mixer, ffn in roles:
            if mixer == "attn":
                f = _attn_flops(cfg, t_q, int(t_kv * causal_frac))
            else:
                f = _mamba_flops(cfg, t_q)
            if ffn == "moe":
                f += _moe_flops(cfg, t_q)
            elif ffn == "dense":
                f += _mlp_flops(cfg, t_q, cfg.d_ff)
            total += f
        return total * units

    if shape.kind in ("train", "prefill"):
        t = b * s
        if cfg.family == "audio":
            t_src, t_tgt = b * s // 2, b * s // 2
            enc = cfg.encoder_layers * (
                _attn_flops(cfg, t_src, s // 2) + _mlp_flops(cfg, t_src, cfg.d_ff)
            )
            dec = cfg.num_layers * (
                _attn_flops(cfg, t_tgt, (s // 2) * 0.5)
                + _attn_flops(cfg, t_tgt, s // 2)  # cross
                + _mlp_flops(cfg, t_tgt, cfg.d_ff)
            )
            fwd = enc + dec + 2 * t_tgt * cfg.d_model * cfg.vocab_size
        else:
            fwd = stack_flops(t, s, causal_frac=0.5)
            fwd += 2 * t * cfg.d_model * cfg.vocab_size  # lm head
        if shape.kind == "train":
            mult = 4.0 if cfg.remat == "block" else 3.0  # bwd = 2x, remat = +1x
            return fwd * mult
        return fwd
    # decode: one token per sequence, cache length s
    t = b
    if cfg.family == "audio":
        dec = cfg.num_layers * (
            _attn_flops(cfg, t, s) + _attn_flops(cfg, t, s) + _mlp_flops(cfg, t, cfg.d_ff)
        )
        return dec + 2 * t * cfg.d_model * cfg.vocab_size
    total = 0.0
    for mixer, ffn in block_roles(cfg):
        if mixer == "attn":
            total += _attn_flops(cfg, t, s)
        else:
            total += _mamba_decode_flops(cfg, b)
        if ffn == "moe":
            total += _moe_flops(cfg, t)
        elif ffn == "dense":
            total += _mlp_flops(cfg, t, cfg.d_ff)
    total *= cfg.num_layers // len(block_roles(cfg))
    return total + 2 * t * cfg.d_model * cfg.vocab_size


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode counts one token a sequence."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, chips: int) -> float:
    """Per-device device-memory traffic estimate for one step (the reference's
    model: bf16 weights sharded over ``chips``)."""
    pbytes = cfg.param_count() * 2  # bf16 weights
    local_p = pbytes / chips  # FSDP+TP shards over the whole mesh
    b, s = shape.global_batch, shape.seq_len
    dp = max(1, chips // 16)
    if shape.kind == "train":
        t_loc = b * s / dp
        act = cfg.num_layers * t_loc * cfg.d_model * 2 * 8  # rw per sublayer
        # fwd+bwd+remat weight reads, grad write, f32 m/v rw, param update
        wt = local_p * 3 + local_p + (cfg.param_count() * 16 / chips) + local_p
        return wt + act
    if shape.kind == "prefill":
        t_loc = b * s / dp
        act = cfg.num_layers * t_loc * cfg.d_model * 2 * 6
        cache = _cache_bytes(cfg, b, s) / chips
        return local_p + act + cache
    cache = _cache_bytes(cfg, b, s) / chips
    return local_p + 2 * cache / max(s, 1) + cache  # read whole cache, write 1 tok


def _cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    roles = _roles(cfg)
    units = cfg.num_layers // len(roles)
    n_attn = sum(1 for m, _ in roles if m == "attn") * units
    n_ssm = sum(1 for m, _ in roles if m == "mamba") * units
    if cfg.family == "audio":
        n_attn = cfg.num_layers * 2  # self + cross
    kv_bytes = 1 if cfg.kv_cache_dtype == "int8" else 2
    kv = 2 * n_attn * b * s * cfg.num_kv_heads * (
        cfg.resolved_head_dim * kv_bytes + (4 if kv_bytes == 1 else 0)
    )
    ssm = n_ssm * b * (cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state) * 4 if n_ssm else 0
    return kv + ssm


def analytic_report(cfg: ModelConfig, shape: ShapeSpec, chips: int) -> Dict[str, float]:
    sf = step_flops(cfg, shape)
    mf = model_flops(cfg, shape)
    return {
        "analytic_step_flops_global": sf,
        "analytic_step_flops_per_device": sf / chips,
        "model_flops_6nd": mf,
        "useful_ratio_model_over_step": mf / sf if sf else 0.0,
        "analytic_hbm_bytes_per_device": step_hbm_bytes(cfg, shape, chips),
    }
