"""Mamba2-370M: attention-free SSD stack, 48 layers, state 128, no FFN.
[arXiv:2405.21060; unverified]

The registrations of the reference's ``repro/configs/mamba2_370m.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64,
        pos_embed="none", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm", reduced=True,
        num_layers=4, d_model=64, num_heads=1, num_kv_heads=1,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_headdim=16,
        pos_embed="none", tie_embeddings=True, dtype="float32",
    )


register("mamba2-370m", full, reduced)
