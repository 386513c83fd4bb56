"""train_step / serve_step factories, as the reference's ``repro/train/train_step.py``.

``make_train_step(cfg)`` builds the full optimisation step: loss (CE + MoE
aux) → gradients by autograd → optional gradient compression → AdamW update
at the schedule's lr for ``step + 1``. On the card the gradient of every full-sequence attention is
the flash kernel's backward (``kernels/flash_attention/ops.py``). The step
is functional: it returns a new state (params, AdamW moments, step) and
leaves the old one as it was.

With a ``compressor`` (``distributed/compression.py``) the gradients pass
through its ``compress_decompress`` before AdamW, and its error-feedback
state rides in ``state["compress"]`` (``Trainer.init_state`` makes it).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NO_POLICY, on_mesh
from repro_torch.models.api import loss_fn, model_decode_step
from repro_torch.optim.adamw import (AdamWConfig, _leaves, _rebuild, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["init_train_state", "make_train_step", "make_serve_step"]


def init_train_state(cfg: ModelConfig, params, opt_cfg: AdamWConfig = AdamWConfig()) -> Dict:
    """{params, opt (AdamWState), step (int32 scalar)} on the params' device."""
    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return {"params": params, "opt": adamw_init(params), "step": step}


def _grads(params, cfg: ModelConfig, batch: Dict, policy=NO_POLICY):
    """(loss, metrics, grads): autograd through ``loss_fn`` from leaves that
    require grad (float leaves only)."""
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in _leaves(params)]
    live = _rebuild(params, iter(leaves))
    loss, metrics = loss_fn(live, cfg, batch, policy=policy)
    wanted = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return loss.detach(), metrics, _rebuild(params, iter(grads))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    schedule: Optional[Callable] = None,
    total_steps: int = 10_000,
    warmup: int = 100,
    compressor=None,
    policy=NO_POLICY,
) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; metrics: loss,
    ce, aux, tokens, grad_norm, lr (0-d tensors). ``compressor``: a
    ``distributed.compression`` compressor or None.

    Under a mesh ``policy`` the state holds this rank's shards
    (``shard_tree`` by ``state_shardings``; the policy carries the params'
    placements, ``with_placements``) and the batch is global: the
    gradients of leaves replicated over a token axis are summed there (an
    FSDP leaf's were reduce-scattered by its gather), a compressor works on
    the shards (bitwise its work on the whole leaves; its error state cut
    like the params, ``state_shardings``), the norm is the mesh's, taken
    after compression (AdamW clips by the norm of what it is given, as the
    reference's ``adamw_update`` does), and AdamW updates each rank's own
    shards."""
    sched = schedule or functools.partial(
        warmup_cosine, peak_lr=opt_cfg.lr, warmup=warmup, total=total_steps)
    mesh = on_mesh(policy)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, metrics, grads = _grads(state["params"], cfg, batch, policy)
        if mesh:
            grads = policy.reduce_grads(grads)
        if compressor is not None:
            kw = {"policy": policy} if mesh else {}
            grads, state_c = compressor.compress_decompress(grads, state.get("compress"), **kw)
        gnorm = global_norm(grads, policy=policy) if mesh else None
        # 1-indexed: warmup starts at lr > 0; on the step's device (no sync)
        lr = sched(state["step"] + 1)
        params, opt, opt_metrics = adamw_update(grads, state["opt"], state["params"], opt_cfg,
                                                lr=lr, gnorm=gnorm)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        if compressor is not None:
            new_state["compress"] = state_c
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_serve_step(cfg: ModelConfig, *, policy=NO_POLICY) -> Callable:
    """One batched greedy decode step: (next tokens, logits, cache); on a
    mesh the tokens of the whole batch, this rank's logits and cache."""

    def serve_step(params, batch: Dict, cache, cache_len: int):
        with torch.no_grad():
            logits, cache = model_decode_step(params, cfg, batch, cache, cache_len,
                                              policy=policy)
        if on_mesh(policy):  # argmax over the padded vocab, as here
            vp = cfg.padded_vocab(1)
            next_tok = policy.bind(len(batch["tokens"]), 1).greedy(logits, vp, vp)
            return next_tok.to(torch.int32), logits, cache
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache

    return serve_step
