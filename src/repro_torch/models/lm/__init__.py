"""Decoder-only LM stack of the port: the ``dense``, ``moe``, ``hybrid``
and ``ssm`` families.

Use the uniform surface in :mod:`repro_torch.models.api`.
"""
