"""Jamba v0.1 52B: hybrid Mamba+attention (1 attn per 8 layers, offset 4), MoE
every 2nd layer (16 experts top-2), no positional embedding. The Mamba mixer
here is the SSD (Mamba2) form with Jamba's state size, as in the reference.
[arXiv:2403.19887; hf]

The registrations of the reference's ``repro/configs/jamba_v0_1_52b.py`` (its
``remat`` knob aside). The FULL weights (~52 B parameters) do not fit one
80 GB card; a caller cuts depth with ``dataclasses.replace(cfg,
num_layers=8)``, one whole unit of eight roles at the published widths.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        num_experts=16, experts_per_token=2, moe_layer_period=2,
        ssm_state=16, ssm_expand=2, ssm_headdim=64,
        attn_layer_period=8, attn_layer_offset=4,
        pos_embed="none", mlp="swiglu",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", reduced=True,
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        num_experts=4, experts_per_token=2, moe_layer_period=2,
        ssm_state=8, ssm_expand=2, ssm_headdim=16,
        attn_layer_period=8, attn_layer_offset=4,
        pos_embed="none", mlp="swiglu", dtype="float32",
    )


register("jamba-v0.1-52b", full, reduced)
