"""Graph substrate: CSR structures and synthetic datasets."""
from repro_torch.graphs.csr import (
    Graph, add_self_loops, disjoint_union, from_edge_list, gcn_norm_coeffs,
)
from repro_torch.graphs.datasets import (
    PAPER_DATASETS, DatasetSpec, make_clustered_graph, make_dataset, make_lognormal_graph,
)
from repro_torch.graphs.partition import (
    Partition, ShardSubgraph, halo_nodes, make_partition, partition_by_edges,
    partition_cut_edges, partition_halo_volume, partition_min_cut, shard_edge_counts,
    shard_subgraph, validate_partition,
)
