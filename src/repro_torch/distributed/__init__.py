"""Sharded execution of partition-aware GNN serving (the host loop and the
mesh backend), and gradient compression for LM training."""
from repro_torch.distributed.compression import Int8Compressor, TopKCompressor, wire_bytes_ratio
from repro_torch.distributed.graph_shard import (
    HaloLedger,
    MeshState,
    ShardedAmpleEngine,
    build_mesh_state,
    make_sharded_engine,
    mesh_aggregate,
    sharded_aggregate,
)
