"""Causal GQA flash attention: the wrapper (``ops.py``) of ``csrc/flash_attention.cu``
and its plain PyTorch version (``ref.py``)."""
