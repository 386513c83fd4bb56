"""Model families of the port: the GNN family (``gnn/``) and the dense and
ssm token families (``lm/``), behind ``api.py``."""
