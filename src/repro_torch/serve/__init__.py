"""Serving engines of the port (the plan-cached GNN engine so far)."""
