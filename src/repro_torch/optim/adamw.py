"""AdamW from scratch, over nested dicts and lists of tensors: f32 moments,
global-norm clip.

A port of the reference's ``repro/optim/adamw.py``, in its order of
operations: clip by the global norm, f32 moments, bias correction, the
decoupled weight decay inside ``delta``, the update cast back to the
parameter dtype. ``torch.optim.AdamW`` neither clips nor orders the decay
so, and is no substitute. The update is functional: it returns new
parameter tensors (requiring grad, so they feed the next step's autograd)
and a new state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32[]
    m: Any  # f32 tree like params
    v: Any


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples (dict keys sorted,
    as ``jax.tree_util`` orders them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken in turn from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple (AdamWState)
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def adamw_init(params) -> AdamWState:
    leaves = _leaves(params)

    def zeros():
        return _rebuild(params, iter(
            [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]))

    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return AdamWState(step=step, m=zeros(), v=zeros())


def global_norm(tree, *, policy=None) -> torch.Tensor:
    """The f32 2-norm of every leaf. Under a mesh ``policy``, ``tree`` holds
    this rank's shards, cut as the policy's params (``policy.placements``):
    each rank squares and sums its shards, a leaf replicated over an
    axis counted only on that axis's rank 0, and one all-reduce over the
    whole mesh sums them, so every rank gets the same norm."""
    import torch.distributed as dist

    # here, not at the top: ``repro_torch.distributed`` imports this module
    from repro_torch.distributed.sharding import _map, all_reduce, on_mesh

    if not on_mesh(policy):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in _leaves(tree)))
    parts = []
    _map(lambda _, x, pl: parts.append(torch.sum(torch.square(x.to(torch.float32)))
                                       if policy.counted_once(pl) else None), tree,
         policy.param_placements())
    first = _leaves(tree)[0]
    sq = sum((p for p in parts if p is not None),
             torch.zeros((), dtype=torch.float32, device=first.device))
    if dist.get_world_size() != policy.mesh.size():
        raise ValueError(f"the mesh ({policy.mesh.size()} ranks) must span the world "
                         f"({dist.get_world_size()})")
    return torch.sqrt(all_reduce(sq, dist.group.WORLD))


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    cfg: AdamWConfig,
    lr: Optional[Union[float, torch.Tensor]] = None,
    *,
    gnorm: Optional[torch.Tensor] = None,
) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, metrics). ``lr`` overrides cfg.lr
    (schedule value); weight decay is decoupled (AdamW). ``gnorm``: the
    gradients' global norm when the caller has it (a mesh's, from
    ``global_norm(..., policy=)``); the update is elementwise, so on a mesh
    each rank updates its own shards."""
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p.requires_grad_(p.is_floating_point()), m_new, v_new

    out = [upd(*a) for a in zip(_leaves(grads), _leaves(state.m), _leaves(state.v),
                                _leaves(params))]

    def pick(i):
        return _rebuild(params, iter([o[i] for o in out]))

    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), {
        "grad_norm": gnorm,
        "lr": torch.as_tensor(lr, dtype=torch.float32),
    }
