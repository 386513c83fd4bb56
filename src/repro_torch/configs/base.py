"""Config system: every served model is a ``ModelConfig`` in a registry.

The GNN subset of the reference's ``repro/configs/base.py``. Each registered
architecture has a FULL config (the published widths) and a REDUCED config
(same family and topology, tiny widths) that tests run on the CPU.
``get_config`` resolves a name through the registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Tuple

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "gnn" is the only family the port serves so far
    num_layers: int
    d_model: int  # input feature width
    d_ff: int  # hidden width
    vocab_size: int  # class count

    # --- GNN (family="gnn"): drives models/gnn/api.py ---
    gnn_arch: str = "gcn"  # gcn | gin | sage | gat (registry key)
    gnn_hidden: Tuple[int, ...] = ()  # explicit hidden widths; () -> (d_ff,)*(L-1)
    gnn_agg: str = ""  # aggregation coefficient mode override ("" = arch default)
    gnn_precision: str = "mixed"  # mixed (Degree-Quant int8/float) | float
    gnn_heads: int = 1  # attention heads (gat); hidden dims must divide by it
    gnn_edges_per_tile: int = 256  # event-driven tile width (AGE lanes)
    gnn_union_node_bucket: int = 0  # pad union batches to node size classes (0=exact)
    gnn_union_edge_bucket: int = 0  # pad union tile stacks to edge size classes

    @property
    def gnn_layer_dims(self) -> Tuple[int, ...]:
        """[feature_dim, hidden..., num_classes] for the GNN family."""
        hidden = self.gnn_hidden or (self.d_ff,) * max(self.num_layers - 1, 0)
        return (self.d_model, *hidden, self.vocab_size)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = ["ample_gnn"]


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
