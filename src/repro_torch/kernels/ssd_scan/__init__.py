"""Mamba2 SSD intra-chunk term: the wrapper (``ops.py``) of ``csrc/ssd_scan.cu``
and its plain PyTorch version (``ref.py``)."""
