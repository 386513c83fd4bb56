"""Wrapper of the SSD intra-chunk kernel, in the layout of the reference's
``repro/kernels/ssd_scan``: cc/bc f32 [B,NC,Q,N], xdt f32 [B,NC,H,Q,P],
acum f32 [B,NC,H,Q] in, f32 [B,NC,H,Q,P] out.

A CUDA tensor launches ``csrc/ssd_scan.cu`` (f32 kept on the TF32 tensor
cores by splitting each operand in two TF32 terms); a CPU tensor takes the
plain version (``ref.py``). The kernel has no backward: under grad, an input
that requires grad raises (``build.require_no_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

__all__ = ["KERNEL", "MAX_CHUNK", "MAX_HEADDIM", "HEADS_PER_BLOCK", "ssd_intra_chunk"]

KERNEL = "ssd_intra_chunk"
MAX_CHUNK = 256  # C Bᵀ rows of a block stay in shared memory: 64 x Q f32
MAX_HEADDIM = 128
HEADS_PER_BLOCK = 2  # heads of one block of the main kernel


def ssd_intra_chunk(cc, bc, xdt, acum):
    if cc.dim() != 4 or xdt.dim() != 5:
        raise ValueError(f"cc must be [B,NC,Q,N] and xdt [B,NC,H,Q,P], got "
                         f"{tuple(cc.shape)}, {tuple(xdt.shape)}")
    b, nc, q, n = cc.shape
    h, p = xdt.shape[2], xdt.shape[4]
    for name, t, shape in (("bc", bc, (b, nc, q, n)), ("xdt", xdt, (b, nc, h, q, p)),
                           ("acum", acum, (b, nc, h, q))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != cc.device:
            raise ValueError(f"{name} is on {t.device}, cc on {cc.device}")
    if cc.device.type == "cpu":
        return ssd_intra_chunk_ref(cc, bc, xdt, acum)
    if cc.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {cc.device}")
    build.require_no_grad(KERNEL, cc, bc, xdt, acum)
    for name, t in (("cc", cc), ("bc", bc), ("xdt", xdt), ("acum", acum)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q > MAX_CHUNK or p > MAX_HEADDIM:
        raise ValueError(f"chunk {q} and head dim {p} must be <= {MAX_CHUNK} and "
                         f"{MAX_HEADDIM}")
    if n == 0:
        raise ValueError("the state size N must be positive")
    out = torch.empty((b, nc, h, q, p), dtype=torch.float32, device=cc.device)
    q64 = -(-q // 64) * 64
    # C Bᵀ of every chunk, in the kernel's fragment layout (the lower triangle is used)
    cb = torch.empty((b * nc * (q64 // 16) * (q64 // 8) * 128,), dtype=torch.float32,
                     device=cc.device)
    build.call(
        "ample_ssd_intra_chunk", cc.device,
        cc.data_ptr(), bc.data_ptr(), xdt.data_ptr(), acum.data_ptr(), out.data_ptr(),
        cb.data_ptr(), b, nc, q, n, h, p, HEADS_PER_BLOCK,
    )
    build.count_launch(KERNEL)
    return out
