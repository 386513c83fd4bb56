"""Hand-written CUDA kernels of the port, one package each.

``<name>/ops.py`` is the wrapper the engine calls (``segment_agg/attn_ops.py``
for the GAT kernels of ``csrc/attn_agg.cu``; ``flash_attention/ops.py`` and
``ssd_scan/ops.py`` for the LM kernels): a CUDA tensor launches the
kernel built from ``repro_torch/csrc/<name>.cu`` (see ``build.py``), a CPU
tensor takes ``<name>/ref.py``, the plain PyTorch version of the same function.
There is no other switch and no fallback from the kernel to the plain version.
"""
