"""The paper's workload plus the attention extension: GCN/GIN/GraphSAGE/GAT
inference over Table-4 graphs.

The same four registrations as the reference's ``repro/configs/ample_gnn.py``.
d_model carries the feature width, d_ff the hidden width and vocab_size the
class count; ``gnn_arch`` selects the registry entry, ``gnn_precision`` the
Degree-Quant policy, ``gnn_heads`` the GAT attention heads (hidden widths
must divide by it). The FULL configs are Yelp-scale (717k nodes, 300
features, 100 classes); the REDUCED ones run on the CPU in tests. The port
serves all four: ``ample-gcn``, ``ample-gin``, ``ample-sage`` and
``ample-gat``.
"""
import functools

from repro_torch.configs.base import ModelConfig, register

# GAT concatenates head outputs on hidden layers, so d_ff % heads == 0.
_HEADS = {"gat": 4}
_HEADS_REDUCED = {"gat": 2}


def _full(arch: str) -> ModelConfig:
    return ModelConfig(
        name=f"ample-{arch}", family="gnn", gnn_arch=arch,
        num_layers=2, d_model=300, num_heads=1, num_kv_heads=1,
        d_ff=256, vocab_size=100,  # yelp
        dtype="float32",
        gnn_heads=_HEADS.get(arch, 1),
        # Continuous batching at production scale: admit up to 8 graphs per
        # micro-batch and pad the union to coarse size classes so device
        # shapes and the plan cache stay warm under varying request mixes.
        gnn_batch_window=8,
        gnn_union_node_bucket=1024,
        gnn_union_edge_bucket=8192,
    )


def _reduced(arch: str) -> ModelConfig:
    return ModelConfig(
        name=f"ample-{arch}", family="gnn", gnn_arch=arch, reduced=True,
        num_layers=2, d_model=32, num_heads=1, num_kv_heads=1,
        d_ff=16, vocab_size=7, dtype="float32", gnn_edges_per_tile=64,
        gnn_batch_window=4,
        gnn_heads=_HEADS_REDUCED.get(arch, 1),
    )


for _arch in ("gcn", "gin", "sage", "gat"):
    register(
        f"ample-{_arch}",
        functools.partial(_full, _arch),
        functools.partial(_reduced, _arch),
    )
