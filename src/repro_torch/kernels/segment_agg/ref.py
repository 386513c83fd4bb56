"""Plain PyTorch versions of the AGE kernels (``csrc/segment_agg.cu``,
``csrc/attn_agg.cu``).

The same functions as the kernels, by the same route: per-tile segment
results, written straight to the output for nodes that live in one tile and
to compact partial rows for split nodes, whose partials are then combined in
tile order. Rows are f32 or int8 codes with their ``QuantParams``,
dequantized as ``core.quantization.dequantize`` does. Like the kernels, each
writes the rows of its plan's nodes into a caller's ``out`` when given one
and leaves every other row as it is. The CPU tests run them; on the card
they are what the kernels are checked against.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import dequantize

__all__ = [
    "aggregate_tiles_ref",
    "aggregate_tiles_mh_ref",
    "attend_tiles_ref",
    "combine_attention",
]


def _chunks(t: int, tile_chunk: int):
    for t0 in range(0, t, tile_chunk):
        yield t0, min(t, t0 + tile_chunk)


def _lane_values(edge_ids: torch.Tensor, values: torch.Tensor, fill: float) -> torch.Tensor:
    """Per-edge ``values [E_graph(, H)]`` read through a chunk's ``edge_ids``:
    [c, E(, H)], ``fill`` on padding lanes (edge id -1)."""
    live = edge_ids >= 0
    got = values[torch.where(live, edge_ids, 0).long()]
    if values.dim() == 2:
        live = live.unsqueeze(-1)
    return torch.where(live, got, torch.full((), fill, dtype=values.dtype, device=values.device))


def _rows(x: torch.Tensor, qp) -> torch.Tensor:
    """The rows as f32: int8 codes dequantized as ``core.quantization`` does."""
    return x if qp is None else dequantize(x, qp)


def _lane_dest(seg_ids: torch.Tensor, t0: int, t1: int, s: int) -> torch.Tensor:
    """Row of each lane's segment in a [(t1 - t0)·S, …] chunk buffer."""
    base = torch.arange(t1 - t0, device=seg_ids.device).unsqueeze(1) * s
    return (base + seg_ids[t0:t1]).reshape(-1)


def _place(out, partial, rows, out_node, split, t0, t1, num_nodes) -> None:
    """Chunk segment rows → output rows (one-tile nodes) or partial rows."""
    node = out_node[t0:t1].reshape(-1).long()
    slot = split.slot_of[t0:t1].reshape(-1).long()
    direct = (node < num_nodes) & (slot < 0)
    out[node[direct]] = rows[direct]
    part = slot >= 0
    partial[slot[part]] = rows[part]


def _split_sum(partial: torch.Tensor, split) -> torch.Tensor:
    """Each split node's partial rows summed in tile order: [P, …]."""
    ptr = split.split_ptr.long()
    count = ptr[1:] - ptr[:-1]
    acc = torch.zeros((count.numel(),) + partial.shape[1:], dtype=partial.dtype,
                      device=partial.device)
    for k in range(int(count.max()) if count.numel() else 0):
        has = count > k
        acc[has] += partial[ptr[:-1][has] + k]
    return acc


def _aggregate(x, gather_idx, lane_coeff, seg_ids, out_node, split, num_nodes, tile_chunk,
               out=None):
    """x f32[N, D]; ``lane_coeff(t0, t1)`` gives the chunk's coefficients,
    f32[c, E] (one per lane) or f32[c, E, H] (one per lane and head, each head
    owning D / H consecutive columns). ``out``: f32[num_nodes, D], or None
    for zeros."""
    t = gather_idx.shape[0]
    s = out_node.shape[1]
    d = x.shape[1]
    dev = x.device
    if out is None:
        out = torch.zeros((num_nodes, d), dtype=x.dtype, device=dev)
    partial = torch.zeros((split.num_slots, d), dtype=x.dtype, device=dev)
    for t0, t1 in _chunks(t, tile_chunk):
        msg = x[gather_idx[t0:t1].long()]  # [c, E, D]
        cf = lane_coeff(t0, t1)
        if cf.dim() == 3:
            c, e, h = cf.shape
            msg = (msg.view(c, e, h, d // h) * cf.unsqueeze(-1)).view(c, e, d)
        else:
            msg = msg * cf.unsqueeze(-1)
        sums = torch.zeros(((t1 - t0) * s, d), dtype=x.dtype, device=dev)
        sums.index_add_(0, _lane_dest(seg_ids, t0, t1, s), msg.reshape(-1, d))
        _place(out, partial, sums, out_node, split, t0, t1, num_nodes)
    out[split.split_node.long()] = _split_sum(partial, split)
    return out


def aggregate_tiles_ref(
    x: torch.Tensor,  # f32[N, D], or int8 codes with qp
    gather_idx: torch.Tensor,  # int32[T, E]
    coeff: torch.Tensor,  # f32[T, E]
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split,  # ops.SplitMap over the same tiles
    *,
    num_nodes: int,
    qp=None,  # QuantParams of int8 codes
    out=None,  # f32[num_nodes, D]
    tile_chunk: int = 1024,
) -> torch.Tensor:
    """f32[num_nodes, D]: Σ coeff·x[gather_idx] over each node's segments,
    the rows dequantized when they are codes.

    Tiles are processed ``tile_chunk`` at a time, which bounds the gathered
    messages to ``tile_chunk · E · D`` floats.
    """
    return _aggregate(_rows(x, qp), gather_idx, lambda t0, t1: coeff[t0:t1], seg_ids, out_node,
                      split, num_nodes, tile_chunk, out)


def aggregate_tiles_mh_ref(
    x: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    gather_idx: torch.Tensor,  # int32[T, E]
    edge_ids: torch.Tensor,  # int32[T, E] graph edge of each lane, -1 on padding
    edge_coeff: torch.Tensor,  # f32[E_graph, H] per-edge, per-head coefficients
    coeff,  # f32[T, E] static lane coeff, or None (ones)
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split,
    *,
    num_nodes: int,
    qp=None,  # QuantParams of int8 codes
    out=None,  # f32[num_nodes, H, dh]
    tile_chunk: int = 1024,
) -> torch.Tensor:
    """f32[num_nodes, H, dh]: Σ coeff·edge_coeff[edge_id, h]·x[gather_idx, h]
    per head. The lane coefficients are ``coeff · edge_coeff`` in that order
    (0 on padding lanes), the rows dequantized when they are codes."""
    n, h, dh = x.shape

    def lane_coeff(t0, t1):
        cf = _lane_values(edge_ids[t0:t1], edge_coeff, 0.0)
        return cf if coeff is None else coeff[t0:t1].unsqueeze(-1) * cf

    flat = None if out is None else out.view(num_nodes, h * dh)
    res = _aggregate(_rows(x, qp).reshape(n, h * dh), gather_idx, lane_coeff, seg_ids,
                     out_node, split, num_nodes, tile_chunk, flat)
    return res.view(num_nodes, h, dh)


def combine_attention(
    m: torch.Tensor,  # f32[R, H] segment max of each partial row
    l: torch.Tensor,  # f32[R, H] Σ exp(score − m)
    a: torch.Tensor,  # f32[R, H, dh] Σ coeff·exp(score − m)·x
    row_node: torch.Tensor,  # int[R] node of each row; num_nodes = none
    *,
    num_nodes: int,
) -> torch.Tensor:
    """Cross-row log-sum-exp combine → f32[num_nodes, H, dh].

    ``M = max m`` per node (0 where no row is finite), ``L = Σ l·exp(m − M)``,
    ``A = Σ a·exp(m − M)``, ``out = A / L`` (``A`` where ``L`` is 0). Rows
    are summed in row order.
    """
    r, h = m.shape
    node = row_node.long()
    big_m = torch.full((num_nodes + 1, h), float("-inf"), dtype=m.dtype, device=m.device)
    big_m.scatter_reduce_(0, node.unsqueeze(1).expand(r, h), m, "amax")
    big_m = torch.where(torch.isfinite(big_m), big_m, torch.zeros_like(big_m))
    # Rows of empty segments carry m = −inf → scale 0, so they vanish here.
    scale = torch.exp(m - big_m[node])
    big_l = torch.zeros((num_nodes + 1, h), dtype=m.dtype, device=m.device)
    big_l.index_add_(0, node, l * scale)
    big_a = torch.zeros((num_nodes + 1,) + a.shape[1:], dtype=a.dtype, device=a.device)
    big_a.index_add_(0, node, a * scale.unsqueeze(-1))
    denom = torch.where(big_l > 0, big_l, torch.ones_like(big_l))
    return (big_a / denom.unsqueeze(-1))[:num_nodes]


def attend_tiles_ref(
    z: torch.Tensor,  # f32[N, H, dh], or int8 codes with qp
    gather_idx: torch.Tensor,  # int32[T, E]
    edge_ids: torch.Tensor,  # int32[T, E] graph edge of each lane, -1 on padding
    scores: torch.Tensor,  # f32[E_graph, H] raw scores
    coeff: torch.Tensor,  # f32[T, E] static lane coeff
    seg_ids: torch.Tensor,  # int32[T, E]
    out_node: torch.Tensor,  # int32[T, S]
    split,
    *,
    num_nodes: int,
    leaky_slope: float,
    qp=None,  # QuantParams of int8 codes
    out=None,  # f32[num_nodes, H, dh]
    tile_chunk: int = 512,
) -> torch.Tensor:
    """softmax(LeakyReLU(scores)) aggregate per destination: f32[N, H, dh].

    Scores are read through ``edge_ids`` (padding lanes are −inf), codes
    dequantized. Per tile and segment: ``m`` = segment max of the activated scores (0
    stands in for an empty segment's −inf before the ``exp``),
    ``l = Σ exp(sc − m)``, ``a = Σ coeff·exp(sc − m)·z[idx]``. A node in one
    tile gets ``a / l``; a split node's rows go through ``combine_attention``.
    """
    n, h, dh = z.shape
    t = gather_idx.shape[0]
    s = out_node.shape[1]
    d = h * dh
    z = _rows(z, qp)
    dev = z.device
    x = z.reshape(n, d)
    if out is None:
        out = torch.zeros((num_nodes, h, dh), dtype=z.dtype, device=dev)
    pm = torch.full((split.num_slots, h), float("-inf"), dtype=z.dtype, device=dev)
    pl = torch.zeros((split.num_slots, h), dtype=z.dtype, device=dev)
    pa = torch.zeros((split.num_slots, h, dh), dtype=z.dtype, device=dev)
    for t0, t1 in _chunks(t, tile_chunk):
        c = t1 - t0
        dest = _lane_dest(seg_ids, t0, t1, s)
        sc = _lane_values(edge_ids[t0:t1], scores, float("-inf")).reshape(-1, h)
        sc = torch.where(sc >= 0, sc, leaky_slope * sc)
        m = torch.full((c * s, h), float("-inf"), dtype=z.dtype, device=dev)
        m.scatter_reduce_(0, dest.unsqueeze(1).expand(-1, h), sc, "amax")
        m_fin = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(sc - m_fin[dest])  # [c·E, H]
        l = torch.zeros((c * s, h), dtype=z.dtype, device=dev).index_add_(0, dest, p)
        w = p * coeff[t0:t1].reshape(-1, 1)
        msg = x[gather_idx[t0:t1].reshape(-1).long()].view(-1, h, dh) * w.unsqueeze(-1)
        a = torch.zeros((c * s, h, dh), dtype=z.dtype, device=dev).index_add_(0, dest, msg)
        final = a / torch.where(l > 0, l, torch.ones_like(l)).unsqueeze(-1)
        node = out_node[t0:t1].reshape(-1).long()
        slot = split.slot_of[t0:t1].reshape(-1).long()
        direct = (node < num_nodes) & (slot < 0)
        out[node[direct]] = final[direct]
        part = slot >= 0
        pm[slot[part]] = m[part]
        pl[slot[part]] = l[part]
        pa[slot[part]] = a[part]
    ptr = split.split_ptr.long()
    rows_of = torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=dev), ptr[1:] - ptr[:-1])
    out[split.split_node.long()] = combine_attention(
        pm, pl, pa, rows_of, num_nodes=int(ptr.numel() - 1))
    return out
