"""Gradient compression with error feedback: top-k, and int8 with stochastic rounding.

A port of the reference's ``repro/distributed/compression.py``. Both
compressors carry **error feedback**: what compression dropped is added back
to the next step's gradient, leaf by leaf, in an f32 state shaped like the
gradients.

* ``TopKCompressor`` keeps the ``ratio`` fraction of largest ``|g + err|``
  entries of each leaf (ties at the threshold kept); on the wire that is
  values and indices, ``2 * ratio`` of the f32 bytes.
* ``Int8Compressor`` sends each leaf as symmetric int8 codes at one scale,
  rounded stochastically (unbiased: E[q] = g / scale), a quarter of the
  bytes.

``compress_decompress`` returns the gradients as the receiving end would see
them and the new error state; the train step feeds them to AdamW. Leaves are
taken in the optimiser's order (``optim/adamw.py::_leaves``, dict keys
sorted), which is ``jax.tree_util``'s, so a leaf's index is the reference's.

The int8 draws come from a ``torch.Generator`` on the leaf's device seeded
from ``seed`` and the leaf's index on every call, so every step draws the
same uniforms for a leaf, as the reference's ``fold_in(PRNGKey(seed), i)``
does (ROADMAP.md, reference caveats). ``int8_leaf`` takes the draws, so a
caller may feed it any: the tests give it the reference's.

Under a mesh ``policy`` (``compress_decompress(..., policy=)``) each leaf is
this rank's shard, cut as the policy's params (``policy.placements``), and
the result is bitwise the unsharded compressor's on the whole leaf: top-k
takes the leaf's threshold from the union of every shard's top
``min(k, shard size)`` magnitudes (all-gathered over the mesh dims the leaf
is cut on: k values a rank, not the leaf); int8 takes its scale from a max
all-reduce over those dims and its uniforms from the whole leaf's draws,
cut to the rank's block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (_coordinate, _local_slice, all_gather,
                                              all_reduce, on_mesh, placements_by_leaf,
                                              whole_shape)
from repro_torch.optim.adamw import _leaves, _rebuild

__all__ = ["TopKCompressor", "Int8Compressor", "int8_leaf", "topk_leaf", "wire_bytes_ratio"]


def _zeros_like_tree(grads) -> Any:
    return _rebuild(grads, iter([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                 for g in _leaves(grads)]))


class _Shards:
    """How one leaf is cut on a mesh: the groups of the mesh dims that cut
    it, its whole numel, and its block of a whole tensor (none on one
    device)."""

    def __init__(self, policy=None, placements=None):
        self.policy, self.placements = policy, placements
        self.groups, self.ranks = [], 1
        if policy is not None:
            for i, p in enumerate(placements):
                if hasattr(p, "dim"):
                    self.groups.append(policy.mesh.get_group(i))
                    self.ranks *= int(policy.mesh.size(i))

    def whole_shape(self, shape) -> Tuple[int, ...]:
        if not self.groups:
            return tuple(shape)
        return whole_shape(shape, self.placements, self.policy.mesh)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        if not self.groups:
            return t
        mesh = self.policy.mesh
        return _local_slice(t, self.placements, mesh, _coordinate(mesh))


_WHOLE = _Shards()


def _map_leaves(fn, grads, state, policy=None) -> Tuple[Any, Any]:
    """``fn(index, leaf, its error, its _Shards)`` over the leaves: (sent
    tree, error tree)."""
    if on_mesh(policy):
        cuts = [_Shards(policy, pl)
                for pl in placements_by_leaf(grads, policy.param_placements())]
    else:
        cuts = [_WHOLE] * len(_leaves(grads))
    outs = [fn(i, g, e, c) for i, (g, e, c) in enumerate(zip(_leaves(grads), _leaves(state), cuts))]
    return (_rebuild(grads, iter([o[0] for o in outs])),
            _rebuild(grads, iter([o[1] for o in outs])))


def topk_leaf(g: torch.Tensor, err: torch.Tensor, ratio: float,
              shards: _Shards = _WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(what is sent, in ``g``'s dtype; the new f32 error) of one leaf (of
    its shard, cut as ``shards`` says: the threshold is the whole leaf's)."""
    flat = (g.to(torch.float32) + err).reshape(-1)
    k = max(1, int(flat.shape[0] * shards.ranks * ratio))
    top = torch.topk(flat.abs(), min(k, flat.shape[0])).values
    for grp in shards.groups:  # the union holds the whole leaf's k largest
        top = torch.cat(all_gather(top, grp))
        top = torch.topk(top, min(k, top.shape[0])).values
    thresh = top[k - 1]
    sent = torch.where(flat.abs() >= thresh, flat, 0.0)
    return sent.reshape(g.shape).to(g.dtype), (flat - sent).reshape(g.shape)


def int8_leaf(g: torch.Tensor, err: torch.Tensor, u: torch.Tensor,
              shards: _Shards = _WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the dequantized codes, in ``g``'s dtype; the new f32 error) of one
    leaf, rounded up where the uniform draw ``u`` (f32, ``g``'s shape) falls
    below the fraction (of its shard, cut as ``shards`` says: the scale is
    the whole leaf's)."""
    g32 = g.to(torch.float32) + err
    amax = g32.abs().max()
    for grp in shards.groups:
        amax = all_reduce(amax, grp, op="max")
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    x = g32 / scale
    lo = torch.floor(x)
    q = torch.clamp(lo + (u < x - lo), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.to(g.dtype), g32 - deq


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Keep the top ``ratio`` fraction of each leaf's entries by magnitude."""

    ratio: float = 0.01

    def init_state(self, grads) -> Any:
        return _zeros_like_tree(grads)

    @torch.no_grad()
    def compress_decompress(self, grads, state: Optional[Any], *,
                            policy=None) -> Tuple[Any, Any]:
        state = self.init_state(grads) if state is None else state
        return _map_leaves(lambda i, g, e, c: topk_leaf(g, e, self.ratio, c), grads, state,
                           policy)


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Per-leaf symmetric int8 with stochastic rounding and error feedback."""

    seed: int = 0

    def init_state(self, grads) -> Any:
        return _zeros_like_tree(grads)

    def draws(self, index: int, shape, device) -> torch.Tensor:
        """Leaf ``index``'s uniform draws in [0, 1), f32, the same on every call."""
        gen = torch.Generator(device=device)
        gen.manual_seed((int(self.seed) << 32) + int(index))
        return torch.rand(tuple(shape), generator=gen, dtype=torch.float32, device=device)

    @torch.no_grad()
    def compress_decompress(self, grads, state: Optional[Any], *,
                            policy=None) -> Tuple[Any, Any]:
        state = self.init_state(grads) if state is None else state
        return _map_leaves(lambda i, g, e, c: int8_leaf(
            g, e, c.block(self.draws(i, c.whole_shape(g.shape), g.device)), c), grads, state,
            policy)


def wire_bytes_ratio(compressor) -> float:
    """Bytes on the wire against a raw f32 all-reduce."""
    if isinstance(compressor, TopKCompressor):
        return 2.0 * compressor.ratio  # values + indices
    if isinstance(compressor, Int8Compressor):
        return 0.25
    return 1.0
