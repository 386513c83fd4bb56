"""Serving engines of the port: the plan-cached GNN engine (``gnn_engine.py``),
its continuous-batching front (``async_gnn.py``), the multi-tenant router over
that front (``tenancy/``) with its telemetry (``telemetry.py``), and the
token-family engine (``engine.py``)."""
