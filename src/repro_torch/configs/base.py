"""Config system: every served model is a ``ModelConfig`` in a registry.

The subset of the reference's ``repro/configs/base.py`` that the port serves:
the GNN family and the ``dense`` and ``ssm`` token families. Each registered
architecture has a FULL config (the published widths) and a REDUCED config
(same family and topology, tiny widths) that tests run on the CPU.
``get_config`` resolves a name through the registry.

Left out of the reference's fields: ``attention_impl`` (a CUDA tensor runs
the flash kernel, a CPU tensor its plain version; there is no other switch),
the MoE, hybrid, enc-dec, M-RoPE and embeds-input fields (their families are
not ported yet), ``remat``/``scan_layers`` (training and XLA knobs) and the
GNN serving knobs of modules not ported yet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "pad_to_multiple"]


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # gnn | dense | ssm (the families the port serves)
    num_layers: int
    d_model: int  # GNN: input feature width
    num_heads: int
    num_kv_heads: int
    d_ff: int  # GNN: hidden width
    vocab_size: int  # GNN: class count
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"  # rope | none (mamba)

    # --- MLP flavour ---
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    mlp_bias: bool = False

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- GNN (family="gnn"): drives models/gnn/api.py ---
    gnn_arch: str = "gcn"  # gcn | gin | sage | gat (registry key)
    gnn_hidden: Tuple[int, ...] = ()  # explicit hidden widths; () -> (d_ff,)*(L-1)
    gnn_agg: str = ""  # aggregation coefficient mode override ("" = arch default)
    gnn_precision: str = "mixed"  # mixed (Degree-Quant int8/float) | float
    gnn_heads: int = 1  # attention heads (gat); hidden dims must divide by it
    gnn_edges_per_tile: int = 256  # event-driven tile width (AGE lanes)
    gnn_union_node_bucket: int = 0  # pad union batches to node size classes (0=exact)
    gnn_union_edge_bucket: int = 0  # pad union tile stacks to edge size classes

    # --- numerics ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # bfloat16 | float32
    kv_cache_dtype: str = "model"  # model (= dtype) | int8

    # reduced smoke-config marker
    reduced: bool = False

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def gnn_layer_dims(self) -> Tuple[int, ...]:
        """[feature_dim, hidden..., num_classes] for the GNN family."""
        hidden = self.gnn_hidden or (self.d_ff,) * max(self.num_layers - 1, 0)
        return (self.d_model, *hidden, self.vocab_size)

    @property
    def is_ssm_only(self) -> bool:
        # The port has no hybrid fields (attn_layer_period): a config with an
        # SSM state is a pure Mamba2 stack.
        return self.ssm_state > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def padded_vocab(self, tp: int) -> int:
        return pad_to_multiple(self.vocab_size, tp)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = [
    "qwen3_8b",
    "qwen2_1_5b",
    "smollm_360m",
    "nemotron_4_15b",
    "mamba2_370m",
    "ample_gnn",
]


def register(name: str, full: Callable[[], ModelConfig], reduced: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def _ensure_loaded():
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    name = name.replace("_", "-")
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))
