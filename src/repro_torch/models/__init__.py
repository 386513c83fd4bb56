"""Model families of the port: the GNN family (``gnn/``) and the dense, MoE,
hybrid and ssm token families (``lm/``), behind ``api.py``."""
