"""Serving engines of the port: the plan-cached GNN engine (``gnn_engine.py``)
and the token-family engine (``engine.py``)."""
