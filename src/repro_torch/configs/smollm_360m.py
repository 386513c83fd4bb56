"""SmolLM-360M: llama-architecture small model, GQA kv=5, tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M; hf]

The registrations of the reference's ``repro/configs/smollm_360m.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
        d_ff=2560, vocab_size=49152, mlp="swiglu", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", reduced=True,
        num_layers=3, d_model=60, num_heads=3, num_kv_heads=1, head_dim=20,
        d_ff=96, vocab_size=512, mlp="swiglu", tie_embeddings=True,
        dtype="float32",
    )


register("smollm-360m", full, reduced)
