"""Graph substrate: CSR structures and synthetic datasets."""
from repro_torch.graphs.csr import (
    Graph, add_self_loops, disjoint_union, from_edge_list, gcn_norm_coeffs,
)
from repro_torch.graphs.datasets import (
    PAPER_DATASETS, DatasetSpec, make_dataset, make_lognormal_graph,
)
