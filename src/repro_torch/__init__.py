"""PyTorch port of the AMPLE reproduction, for CUDA cards (Hopper).

Mirrors the layout of the JAX reference package ``repro`` module for module
and imports nothing of it. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; a CUDA tensor goes through the hand-written kernels
under ``csrc/``, a CPU tensor through their plain PyTorch versions.
"""
