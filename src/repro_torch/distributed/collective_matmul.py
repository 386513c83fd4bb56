"""Collective matmuls: overlap a tensor-parallel collective with the products.

The reference's ``repro/distributed/collective_matmul.py``: instead of a
whole all-gather (or reduce-scatter) and then one product, the collective is
a ring of ``n - 1`` point-to-point steps over the ``axis`` group
(``batch_isend_irecv``), and each arriving block is multiplied while the
next one moves (Wang et al., ASPLOS'23; MaxText, Megatron). On the card a
block through gloo is staged through page-locked host memory by copies on a
side stream (``sharding.RingShift``), so the product of step s on the
default stream overlaps the transfer of step s + 1. The products are
``torch.matmul``, as the reference's are ``einsum``: no Pallas kernel there,
none here. Forward only, on local tensors:

``allgather_matmul``      y[M, N/n]  = (AG_rows x)[M, K] @ w[K, N/n]
                          (x arrives row-sharded: the SP residual layout)
``reduce_scatter_matmul`` y[M/n, N]  = RS_rows(Σ_k x[M, K/n] @ w[K/n, N])
                          (the down-projection / row-parallel side)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import RingShift

__all__ = ["allgather_matmul", "reduce_scatter_matmul"]


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *,
                     axis: str = "model") -> torch.Tensor:
    """Ring-pipelined ``all_gather(x, rows) @ w`` on this rank's blocks.

    x: [M/n, K], this rank's rows; w: [K, N/n], its columns; returns its
    columns of y, [M, N/n]. At ring step s the rank holds the block that
    started at rank (r + s) mod n: it writes that block's product into the
    matching row band of y while the block moves on to rank r - 1."""
    group = mesh.get_group(axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    m_loc = x.shape[0]
    y = x.new_empty((m_loc * n, w.shape[-1]))
    blk = x
    for s in range(n):
        shift = RingShift(blk, group, -1) if s < n - 1 else None
        src = (r + s) % n  # the owner of the block held
        y[src * m_loc:(src + 1) * m_loc] = blk @ w
        if shift is not None:
            blk = shift.wait()
    return y


def reduce_scatter_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *,
                          axis: str = "model") -> torch.Tensor:
    """Ring-pipelined ``reduce_scatter_rows(x @ w)`` for K-sharded operands.

    x: [M, K/n], w: [K/n, N], this rank's blocks; returns its rows of y,
    [M/n, N]. The partial product is computed one M-band at a time in ring
    order (receive, accumulate, forward to rank r + 1), each band's product
    while the running sum of the previous band moves; after n steps rank r
    holds Σ_j x_j[band r] @ w_j. (The reference's first step forwards a
    zero sum; here it starts from the first product.)"""
    group = mesh.get_group(axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    chunk = x.shape[0] // n
    acc = None
    for s in range(n):
        shift = RingShift(acc, group, 1) if acc is not None else None
        c = (r - s - 1) % n  # the band this step adds
        prod = x[c * chunk:(c + 1) * chunk] @ w
        acc = prod if shift is None else shift.wait() + prod
    return acc
