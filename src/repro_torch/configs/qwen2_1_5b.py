"""Qwen2-1.5B: dense, GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]

The registrations of the reference's ``repro/configs/qwen2_1_5b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936, qkv_bias=True, mlp="swiglu",
        rope_theta=1e6, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", reduced=True,
        num_layers=3, d_model=60, num_heads=3, num_kv_heads=1, head_dim=20,
        d_ff=128, vocab_size=512, qkv_bias=True, mlp="swiglu",
        tie_embeddings=True, dtype="float32",
    )


register("qwen2-1.5b", full, reduced)
