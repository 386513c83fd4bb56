"""Command-line entry points (ports of ``repro/launch``)."""
