"""SeamlessM4T-medium: encoder-decoder transformer backbone (12+12),
LayerNorm/GELU/sinusoidal positions. The speech frontend is a stub: the
encoder consumes precomputed frame embeddings (``src_embeds``).
[arXiv:2308.11596; hf]

The registrations of the reference's ``repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, encoder_layers=12, d_model=1024, num_heads=16,
        num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206,
        norm="layernorm", mlp="gelu", pos_embed="sin", embeds_input=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio", reduced=True,
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        norm="layernorm", mlp="gelu", pos_embed="sin", embeds_input=True,
        dtype="float32",
    )


register("seamless-m4t-medium", full, reduced)
