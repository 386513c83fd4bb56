"""Optimiser and learning-rate schedules (ports of ``repro/optim``)."""
