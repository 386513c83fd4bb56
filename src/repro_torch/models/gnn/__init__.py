"""The paper's GNNs behind the arch registry (GCN so far).

Use the uniform surface in :mod:`repro_torch.models.gnn.api`
(``gnn_init`` / ``gnn_apply`` / ``gnn_reference`` / ``gnn_forward``).
"""
