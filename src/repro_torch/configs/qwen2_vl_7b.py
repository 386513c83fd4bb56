"""Qwen2-VL-7B backbone: M-RoPE (t/h/w rotary sections), GQA kv=4, QKV bias.
The vision frontend (dynamic-resolution ViT) is a stub: patch embeddings and
3D positions arrive as input (``embeds``, ``positions``).
[arXiv:2409.12191; hf]

The registrations of the reference's ``repro/configs/qwen2_vl_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
        d_ff=18944, vocab_size=152064, qkv_bias=True, mlp="swiglu",
        pos_embed="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        embeds_input=True, remat="block",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm", reduced=True,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, qkv_bias=True, mlp="swiglu",
        pos_embed="mrope", mrope_sections=(4, 2, 2), embeds_input=True,
        dtype="float32",
    )


register("qwen2-vl-7b", full, reduced)
