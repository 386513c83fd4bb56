"""Nemotron-4 15B: dense, GQA kv=8, squared-ReLU MLP, LayerNorm.
[arXiv:2402.16819; unverified]

The registrations of the reference's ``repro/configs/nemotron_4_15b.py``
(its ``remat`` knob aside).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000, mlp="relu2", norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense", reduced=True,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, mlp="relu2", norm="layernorm", dtype="float32",
    )


register("nemotron-4-15b", full, reduced)
