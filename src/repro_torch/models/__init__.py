"""Model families of the port (the GNN family so far)."""
