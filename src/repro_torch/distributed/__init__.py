"""Sharded execution: the host-loop backend of partition-aware GNN serving."""
from repro_torch.distributed.graph_shard import (
    HaloLedger,
    ShardedAmpleEngine,
    make_sharded_engine,
    sharded_aggregate,
)
