"""Granite-3.0 3B-A800M MoE: 40 experts top-8, tiny expert FFN (512), GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The registrations of the reference's ``repro/configs/granite_moe_3b_a800m.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155,
        num_experts=40, experts_per_token=8, mlp="swiglu", rope_theta=1e4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe", reduced=True,
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512,
        num_experts=10, experts_per_token=4, mlp="swiglu", dtype="float32",
    )


register("granite-moe-3b-a800m", full, reduced)
