"""Decoder-only LM stack of the port: the ``dense`` and ``ssm`` families.

Use the uniform surface in :mod:`repro_torch.models.api`.
"""
