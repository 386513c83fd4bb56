"""Llama-4 Maverick 400B-A17B: interleaved MoE (128 experts, top-1) + shared
expert, GQA kv=8, early-fusion multimodal (frontend stubbed — text path only).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The registrations of the reference's
``repro/configs/llama4_maverick_400b_a17b.py`` (its ``remat`` knob aside).
The FULL weights (~400 B parameters) do not fit one 80 GB card; a caller
cuts depth with ``dataclasses.replace(cfg, num_layers=2)``, one whole
``(attn, dense), (attn, moe)`` unit at the published widths.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        num_experts=128, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True, mlp="swiglu", rope_theta=5e5,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", reduced=True,
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        num_experts=8, experts_per_token=1, moe_layer_period=2,
        moe_shared_expert=True, mlp="swiglu", dtype="float32",
    )


register("llama4-maverick-400b-a17b", full, reduced)
