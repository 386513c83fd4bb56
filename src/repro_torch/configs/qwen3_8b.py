"""Qwen3-8B: dense, GQA kv=8, qk-norm (per-head RMSNorm on q/k), SwiGLU.
[hf:Qwen/Qwen3-8B; hf]

The registrations of the reference's ``repro/configs/qwen3_8b.py``
(``remat="block"`` included).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=12288, vocab_size=151936, qk_norm=True, mlp="swiglu",
        rope_theta=1e6, remat="block",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense", reduced=True,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, qk_norm=True, mlp="swiglu", dtype="float32",
    )


register("qwen3-8b", full, reduced)
