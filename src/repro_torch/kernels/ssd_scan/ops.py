"""Wrapper of the SSD intra-chunk kernel, in the layout of the reference's
``repro/kernels/ssd_scan``: cc/bc f32 [B,NC,Q,N], xdt f32 [B,NC,H,Q,P],
acum f32 [B,NC,H,Q] in, f32 [B,NC,H,Q,P] out.

A CUDA tensor launches ``csrc/ssd_scan.cu`` (f32 kept on the TF32 tensor
cores by splitting each operand in two TF32 terms); a CPU tensor takes the
plain version (``ref.py``).

Under grad (grad mode on and an input that requires grad) the call goes
through ``SSDIntraChunkFunction``: its forward is the same kernel, and its
backward launches the three kernels of ``csrc/ssd_scan_bwd.cu`` (f32 kept on
the TF32 tensor cores the same way: C Bᵀ once a chunk, one fused dW/dXdt
kernel over runs of heads, then dC, dB and dacum), counted once a call
under ``KERNEL_BWD``. On
CPU tensors the same Function runs ``ssd_intra_chunk_ref`` and
``ssd_intra_chunk_bwd_ref``. A CUDA tensor never takes a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref

__all__ = ["KERNEL", "KERNEL_BWD", "MAX_CHUNK", "MAX_HEADDIM", "HEADS_PER_BLOCK",
           "SSDIntraChunkFunction", "ssd_intra_chunk", "ssd_intra_chunk_bwd",
           "bwd_heads_per_run"]

KERNEL = "ssd_intra_chunk"
KERNEL_BWD = "ssd_intra_chunk_bwd"
MAX_CHUNK = 256  # C Bᵀ rows of a block stay in shared memory: 64 x Q f32
MAX_HEADDIM = 128
HEADS_PER_BLOCK = 2  # heads of one block of the main kernel
# The backward's fused kernel (one block per key tile, chunk and run of
# heads, one block an SM for its shared memory) splits the heads into runs
# until its grid has this many blocks per SM; each run adds a dCB partial
# that the last kernel stages and sums: at most BWD_MAX_RUNS of them, and
# no more than one per BWD_MIN_HEADS heads (a shorter run shares its C Bᵀ
# tiles too little to pay for its partial). One wave (2 runs, 256 blocks)
# was the fastest at the Mamba2-370M training shape and within 1% of the
# fastest at Jamba's; runs of 4 heads were the fastest at the REDUCED
# launcher's shape (tools/ssd_bwd_sweep.py; PERF.md).
BWD_WAVES = 1
BWD_MAX_RUNS = 8
BWD_MIN_HEADS = 4


def _check(cc, bc, xdt, acum):
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


def _cuda_inputs(**tensors):
    """Raise unless every tensor is contiguous f32 on a CUDA device and the
    chunk and head dim fit the kernels."""
    cc = tensors["cc"]
    if cc.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {cc.device}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q, n, p = cc.shape[2], cc.shape[3], tensors["xdt"].shape[4]
    if q > MAX_CHUNK or p > MAX_HEADDIM:
        raise ValueError(f"chunk {q} and head dim {p} must be <= {MAX_CHUNK} and "
                         f"{MAX_HEADDIM}")
    if n == 0:
        raise ValueError("the state size N must be positive")


def ssd_intra_chunk(cc, bc, xdt, acum):
    """``((C Bᵀ) ∘ L) @ Xdt``; under grad the result carries the backward
    kernels' gradient."""
    _check(cc, bc, xdt, acum)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (cc, bc, xdt, acum)):
        return SSDIntraChunkFunction.apply(cc, bc, xdt, acum)
    return _forward(cc, bc, xdt, acum)


def _forward(cc, bc, xdt, acum):
    if cc.device.type == "cpu":
        return ssd_intra_chunk_ref(cc, bc, xdt, acum)
    _cuda_inputs(cc=cc, bc=bc, xdt=xdt, acum=acum)
    b, nc, q, n = cc.shape
    h, p = xdt.shape[2], xdt.shape[4]
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


class SSDIntraChunkFunction(torch.autograd.Function):
    """The SSD intra-chunk term with its backward: the kernels on CUDA
    tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, cc, bc, xdt, acum):
        ctx.save_for_backward(cc, bc, xdt, acum)
        return _forward(cc, bc, xdt, acum)

    @staticmethod
    def backward(ctx, dy):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, dy)


def ssd_intra_chunk_bwd(cc, bc, xdt, acum, dy, *, heads_per_run=None, stages=0):
    """(dcc, dbc, dxdt, dacum) for the upstream gradient ``dy`` [B,NC,H,Q,P]
    of the term: the kernels of ``csrc/ssd_scan_bwd.cu`` on CUDA tensors,
    ``ssd_intra_chunk_bwd_ref`` on CPU tensors. ``dy`` may be the layer's
    permuted view (unit column stride): the kernel reads it at its strides.
    ``heads_per_run`` (default ``bwd_heads_per_run``) and ``stages`` (the
    fused kernel's cp.async ring, 1 or 2 slots; 0 = the deepest that fits)
    are the kernel's design knobs, for ``tools/ssd_bwd_sweep.py``."""
    _check(cc, bc, xdt, acum)
    if tuple(dy.shape) != tuple(xdt.shape) or dy.device != cc.device:
        raise ValueError(f"dy must be {tuple(xdt.shape)} on {cc.device}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    if cc.device.type == "cpu":
        return ssd_intra_chunk_bwd_ref(cc, bc, xdt, acum, dy)
    _cuda_inputs(cc=cc, bc=bc, xdt=xdt, acum=acum)
    if dy.dtype != torch.float32:
        raise TypeError(f"dy must be float32, got {dy.dtype}")
    dy, dy_strides = _dy_rows(dy)
    b, nc, q, n = cc.shape
    h, p = xdt.shape[2], xdt.shape[4]
    tiles = -(-q // 64)
    qp = tiles * 64
    dcc, dbc = torch.empty_like(cc), torch.empty_like(bc)
    dxdt, dacum = torch.empty_like(xdt), torch.empty_like(acum)
    if heads_per_run is None:
        sms = torch.cuda.get_device_properties(cc.device).multi_processor_count
        heads_per_run = bwd_heads_per_run(b * nc, tiles, h, sms)
    runs = -(-h // heads_per_run)
    if not 1 <= runs <= BWD_MAX_RUNS:
        raise ValueError(f"{runs} runs of {heads_per_run} heads: the backward takes 1 to "
                         f"{BWD_MAX_RUNS}")
    # C Bᵀ's tiles on and below the diagonal of every chunk (64 x 64 each),
    # each run's dCB of every chunk ([B, NC, QP, QP], the same tiles written),
    # the sums of G = dW ∘ W over each key tile per row ([B, NC, H, T, QP])
    # and over all rows per key ([B, NC, H, QP]).
    cbt = b * nc * tiles * (tiles + 1) // 2 * 64 * 64
    square, part = b * nc * qp * qp, b * nc * h * qp
    scratch = torch.empty((cbt + runs * square + (tiles + 1) * part,), dtype=torch.float32,
                          device=cc.device)
    cb, dcb, rowp, colp = scratch.split([cbt, runs * square, tiles * part, part])
    build.call(
        "ample_ssd_intra_chunk_bwd", cc.device,
        cc.data_ptr(), bc.data_ptr(), xdt.data_ptr(), acum.data_ptr(), dy.data_ptr(),
        dcc.data_ptr(), dbc.data_ptr(), dxdt.data_ptr(), dacum.data_ptr(),
        cb.data_ptr(), dcb.data_ptr(), rowp.data_ptr(), colp.data_ptr(), b, nc, q, n, h, p,
        *dy_strides,
        heads_per_run, stages,
    )
    build.count_launch(KERNEL_BWD)
    return dcc, dbc, dxdt, dacum


def _dy_rows(dy):
    """``dy`` as the kernel reads it, and its (chunk, head, row) strides in
    floats: the layer's permuted view as it is (unit column stride, one
    stride for the chunk index b·NC + c), anything else copied contiguous."""
    b, nc, h, q, p = dy.shape
    st = dy.stride()
    if st[4] == 1 and (b == 1 or st[0] == nc * st[1]):
        return dy, (st[1], st[2], st[3])
    return dy.contiguous(), (h * q * p, q * p, p)


def bwd_heads_per_run(chunks: int, tiles: int, heads: int, sms: int) -> int:
    """Heads per run of the backward's fused kernel: all of them where its
    grid (``chunks`` × ``tiles`` key tiles) already has ``BWD_WAVES`` blocks
    per SM, else as few as give it that many, at most ``BWD_MAX_RUNS`` and
    at most one per ``BWD_MIN_HEADS`` heads, and no run empty."""
    blocks = chunks * tiles
    want = max(1, min(heads // BWD_MIN_HEADS, BWD_MAX_RUNS,
                      -(-BWD_WAVES * sms // max(blocks, 1))))
    return -(-heads // want)
