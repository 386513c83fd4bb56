"""The LM training step and loop (ports of ``repro/train``)."""
