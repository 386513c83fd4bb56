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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.adamw import _leaves, _rebuild

__all__ = ["TopKCompressor", "Int8Compressor", "int8_leaf", "topk_leaf", "wire_bytes_ratio"]


def _zeros_like_tree(grads) -> Any:
    return _rebuild(grads, iter([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                                 for g in _leaves(grads)]))


def _map_leaves(fn, grads, state) -> Tuple[Any, Any]:
    """``fn(index, leaf, its error)`` over the leaves: (sent tree, error tree)."""
    outs = [fn(i, g, e) for i, (g, e) in enumerate(zip(_leaves(grads), _leaves(state)))]
    return (_rebuild(grads, iter([o[0] for o in outs])),
            _rebuild(grads, iter([o[1] for o in outs])))


def topk_leaf(g: torch.Tensor, err: torch.Tensor, ratio: float) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(what is sent, in ``g``'s dtype; the new f32 error) of one leaf."""
    flat = (g.to(torch.float32) + err).reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    thresh = torch.topk(flat.abs(), k).values[-1]
    sent = torch.where(flat.abs() >= thresh, flat, 0.0)
    return sent.reshape(g.shape).to(g.dtype), (flat - sent).reshape(g.shape)


def int8_leaf(g: torch.Tensor, err: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """(the dequantized codes, in ``g``'s dtype; the new f32 error) of one
    leaf, rounded up where the uniform draw ``u`` (f32, ``g``'s shape) falls
    below the fraction."""
    g32 = g.to(torch.float32) + err
    scale = torch.clamp_min(g32.abs().max() / 127.0, 1e-12)
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
    def compress_decompress(self, grads, state: Optional[Any]) -> Tuple[Any, Any]:
        state = self.init_state(grads) if state is None else state
        return _map_leaves(lambda i, g, e: topk_leaf(g, e, self.ratio), grads, state)


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
    def compress_decompress(self, grads, state: Optional[Any]) -> Tuple[Any, Any]:
        state = self.init_state(grads) if state is None else state
        return _map_leaves(lambda i, g, e: int8_leaf(g, e, self.draws(i, g.shape, g.device)),
                           grads, state)


def wire_bytes_ratio(compressor) -> float:
    """Bytes on the wire against a raw f32 all-reduce."""
    if isinstance(compressor, TopKCompressor):
        return 2.0 * compressor.ratio  # values + indices
    if isinstance(compressor, Int8Compressor):
        return 0.25
    return 1.0
