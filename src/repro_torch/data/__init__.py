"""Synthetic training data (a copy of ``repro/data``)."""
