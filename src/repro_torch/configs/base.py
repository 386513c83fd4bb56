"""Config system: every served model is a ``ModelConfig`` in a registry.

The subset of the reference's ``repro/configs/base.py`` that the port serves:
the GNN family and the ``dense``, ``moe``, ``hybrid`` and ``ssm`` token
families. Each registered architecture has a FULL config (the published
widths) and a REDUCED config (same family and topology, tiny widths) that
tests run on the CPU. ``get_config`` resolves a name through the registry.

Left out of the reference's fields: ``attention_impl`` (a CUDA tensor runs
the flash kernel, a CPU tensor its plain version; there is no other switch),
the enc-dec, M-RoPE and embeds-input fields (their families are not ported
yet), ``remat``/``scan_layers`` (training and XLA knobs) and
``gnn_use_kernel``, which the port has no use for.
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
    family: str  # gnn | dense | moe | hybrid | ssm (the families the port serves)
    num_layers: int
    d_model: int  # GNN: input feature width
    num_heads: int
    num_kv_heads: int
    d_ff: int  # GNN: hidden width
    vocab_size: int  # GNN: class count
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1  # every k-th layer is MoE (llama4/jamba interleave)
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25

    # --- attention flavour ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"  # rope | none (jamba/mamba)

    # --- MLP flavour ---
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    mlp_bias: bool = False

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_layer_period: int = 0  # hybrid: 1 attention layer every k (jamba k=8)
    attn_layer_offset: int = 4

    # --- GNN (family="gnn"): drives models/gnn/api.py ---
    gnn_arch: str = "gcn"  # gcn | gin | sage | gat (registry key)
    gnn_hidden: Tuple[int, ...] = ()  # explicit hidden widths; () -> (d_ff,)*(L-1)
    gnn_agg: str = ""  # aggregation coefficient mode override ("" = arch default)
    gnn_precision: str = "mixed"  # mixed (Degree-Quant int8/float) | float
    gnn_heads: int = 1  # attention heads (gat); hidden dims must divide by it
    gnn_edges_per_tile: int = 256  # event-driven tile width (AGE lanes)
    gnn_num_shards: int = 1  # >1: partition-aware execution (edge-balanced shards)
    # Partitioner for sharded execution: "edges" = contiguous edge-balanced
    # ranges; "mincut" = halo-minimizing multilevel (METIS-style) partition.
    # Extra params ride inline, e.g. "mincut(seed=1,balance=1.1)".
    gnn_partitioner: str = "edges"
    # Overlap each shard's halo exchange with its interior-tile aggregation
    # (scheduler.split_plan_by_halo); outputs stay bitwise-identical.
    gnn_halo_overlap: bool = False
    # Continuous-batching serve knobs (serve/async_gnn.py + GNNServeEngine):
    gnn_batch_window: int = 8  # max requests admitted per micro-batch union
    gnn_union_node_bucket: int = 0  # pad union batches to node size classes (0=exact)
    gnn_union_edge_bucket: int = 0  # pad union tile stacks to edge size classes
    # Latency-aware window close: a partially filled admission window is held
    # open until the oldest queued request has waited this long, then admits
    # whatever arrived (0: admit immediately).
    gnn_window_timeout_ms: float = 0.0
    # Bounded requeue-on-failure: a micro-batch window may fail execution
    # this many times before its tickets are completed with the error.
    gnn_window_retries: int = 3
    # Out-of-core serving (memory/feature_store.py + memory/prefetcher.py):
    # requests whose feature matrix exceeds the budget keep features on the
    # host and stream them chunk-wise (bitwise the in-memory outputs);
    # 0 disables streaming.
    gnn_feature_budget_bytes: int = 0  # device bytes granted to feature chunks
    gnn_feature_chunk_rows: int = 0  # rows per chunk (0 = derive from budget)
    # Locality controls for the streamed path: packing rebuilds tile
    # membership around source chunks (scheduler.pack_tiles_by_chunk);
    # reorder=False keeps plan order.
    gnn_stream_packing: bool = False  # pack tiles by source chunk
    gnn_stream_reorder: bool = True  # locality-reorder tile runs

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
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def gnn_layer_dims(self) -> Tuple[int, ...]:
        """[feature_dim, hidden..., num_classes] for the GNN family."""
        hidden = self.gnn_hidden or (self.d_ff,) * max(self.num_layers - 1, 0)
        return (self.d_model, *hidden, self.vocab_size)

    @property
    def is_hybrid(self) -> bool:
        return self.attn_layer_period > 0 and self.ssm_state > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and self.attn_layer_period == 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def padded_vocab(self, tp: int) -> int:
        return pad_to_multiple(self.vocab_size, tp)

    def param_count(self) -> int:
        """Approximate raw (unpadded) parameter count, the reference's formula."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        mlp_dense = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        per_expert = mlp_dense
        n_moe = self.num_layers // self.moe_layer_period if self.is_moe else 0
        n_dense_mlp = self.num_layers - n_moe
        n_attn = self.num_layers
        ssm = 0
        if self.ssm_state > 0:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_ssm = (
                d * (2 * di + 2 * ns + nh)  # in_proj (x, z, B, C, dt)
                + di * d  # out_proj
                + self.ssm_conv * (di + 2 * ns)
                + 3 * nh
            )
            if self.is_ssm_only:
                n_ssm = self.num_layers
                n_attn = 0
                n_dense_mlp = 0 if not self.is_moe else n_dense_mlp
                if self.d_ff == 0:
                    n_dense_mlp = 0
            else:
                n_attn = self.num_layers // self.attn_layer_period
                n_ssm = self.num_layers - n_attn
            ssm = n_ssm * per_ssm
        total = (
            n_attn * attn
            + n_dense_mlp * mlp_dense
            + n_moe * (self.num_experts * per_expert + d * self.num_experts)
            + (per_expert if (self.is_moe and self.moe_shared_expert) else 0) * n_moe
            + ssm
            + self.vocab_size * d * (1 if self.tie_embeddings else 2)
        )
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed experts only)."""
        if not self.is_moe:
            return self.param_count()
        per_expert = (3 if self.mlp == "swiglu" else 2) * self.d_model * self.d_ff
        n_moe = self.num_layers // self.moe_layer_period
        inactive = n_moe * (self.num_experts - self.experts_per_token) * per_expert
        return int(self.param_count() - inactive)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = [
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "qwen3_8b",
    "qwen2_1_5b",
    "smollm_360m",
    "nemotron_4_15b",
    "jamba_v0_1_52b",
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
