"""AGE kernels over edge tiles: the gather + segment reduce (``ops.py``) and
the multi-head GAT kernels, fused attention and per-head weighted AGE
(``attn_ops.py``)."""
