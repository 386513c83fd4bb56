"""Mixture-of-Experts with event-driven capacity dispatch.

The reference's ``repro/models/lm/moe.py``, with its dispatch groups and
sharding hooks (``policy``). Token→expert routing is the same skewed
bin-packing problem as AMPLE's node→nodeslot scheduling: expert loads are
non-uniform, and a fixed per-expert capacity plays the role of the nodeslot
pool. Dispatch is the sort-based "dropping" formulation:

  1. route: top-k gates per token (softmax router, f32);
  2. schedule: stable-sort (token, k) slots by expert id, rank within expert —
     rank ≥ capacity overflows (drops) exactly like a nodeslot pool saturating;
  3. execute: scatter tokens into the [E, C, D] expert buffer, run all expert
     FFNs as one stacked batched matmul, gather back and combine with gate
     weights.

The capacity C = ceil(T·k/E · capacity_factor) is a Python int from static
shapes, so nothing here waits for the device (no ``.item()``, no boolean
indexing). The combine is in a plan-static order: each (token, k) slot reads
its row of the expert output through the inverse of the sort, and a token's
k rows are summed in one reduction, so a result is the same from run to run
on the card (no float atomics).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import all_reduce, on_mesh
from repro_torch.models.lm.mlp import mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply"]


def moe_init(make, d_model: int, d_ff: int, num_experts: int, kind: str, *,
             shared_expert: bool = False, dtype=torch.bfloat16) -> Dict:
    """The router (f32 whatever the model dtype), the experts' ``mlp_init``
    trees stacked on an expert axis under ``make``'s lead, and the shared
    expert (``make``: a parameter maker of ``transformer.py``)."""
    p = {
        "router": make.normal((d_model, num_experts), d_model**-0.5, torch.float32),
        "experts": mlp_init(make.stacked(num_experts), d_model, d_ff, kind, dtype=dtype),
    }
    if shared_expert:
        p["shared"] = mlp_init(make, d_model, d_ff, kind, dtype=dtype)
    return p


def _expert_ffn(experts: Dict, xin: torch.Tensor, kind: str) -> torch.Tensor:
    """Stacked expert FFN: xin [G, E, C, D] -> [G, E, C, D] (G dispatch
    groups), as one batched matmul an expert over its G·C rows."""
    g, e, c, d = xin.shape
    x3 = xin.transpose(0, 1).reshape(e, g * c, d)
    if kind == "swiglu":
        h = F.silu(torch.bmm(x3, experts["w_gate"])) * torch.bmm(x3, experts["w_up"])
        y = torch.bmm(h, experts["w_down"])
    else:
        h = torch.bmm(x3, experts["w_in"])
        if kind == "relu2":
            h = torch.square(F.relu(h))
        elif kind == "gelu":
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        else:
            raise ValueError(f"unknown mlp kind {kind!r}")
        y = torch.bmm(h, experts["w_out"])
    return y.reshape(e, g, c, y.shape[-1]).transpose(0, 1)


def moe_apply(params: Dict, x: torch.Tensor, *, num_experts: int, top_k: int, kind: str,
              capacity_factor: float = 1.25, return_stats: bool = False, policy=None):
    """x [B, S, D] -> (out [B, S, D], aux) or, with ``return_stats``, (out,
    aux, stats): ``expert_load`` int32 [E] (slots routed to each expert),
    ``dropped_fraction`` (0-d f32, slots past capacity), ``capacity``,
    ``groups``, and the routes ``gate_idx`` [T, k] with the router's
    ``probs`` f32 [T, E]. aux is the Switch loss E · Σ_e f_e · P_e.

    ``policy``: the dispatch groups (``policy.moe_groups(T)``: the schedule,
    sort, rank and capacity, runs in each group of T/G tokens on its own)
    and the ``ebuf``/``ebuf_out`` hooks on the [G, E, C, D] buffer. Under a
    mesh policy in ``tp`` mode the layer runs ``moe_sharded.py`` where it
    applies; on a mesh the aux loss counts every rank's tokens."""
    b, s, d = x.shape
    t, e = b * s, num_experts
    sharded = on_mesh(policy)
    if sharded and not return_stats:
        from repro_torch.models.lm.moe_sharded import moe_apply_sharded, sharded_applicable

        if sharded_applicable(policy, e, t, 0):
            return moe_apply_sharded(params, x, num_experts=e, top_k=top_k, kind=kind,
                                     capacity_factor=capacity_factor, policy=policy)
    groups = policy.moe_groups(t) if policy is not None else 1
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} dispatch groups")
    tg = t // groups
    cap = max(1, int(math.ceil(tg * top_k / e * capacity_factor)))

    # ---- route (f32), every token at once
    logits = x.reshape(t, d).float() @ params["router"]  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    xf, gate_w = x.reshape(groups, tg, d), gate_w.view(groups, tg, top_k)

    # ---- schedule, per group: sort the (token, k) slots by expert, rank, capacity
    flat_e = gate_idx.reshape(groups, tg * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)  # sorted expert ids
    token_of = order // top_k
    counts = torch.zeros((groups, e), dtype=torch.int64, device=x.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(tg * top_k, device=x.device)[None] - torch.gather(starts, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)  # overflow -> sentinel row

    # ---- dispatch / execute (only the sentinel row takes duplicate writes)
    gidx = torch.arange(groups, device=x.device)[:, None]
    buf = x.new_zeros((groups, e * cap + 1, d))
    buf[gidx, slot] = xf[gidx, token_of]
    xin = buf[:, : e * cap].reshape(groups, e, cap, d)
    if policy is not None:
        xin = policy.ebuf(xin)
    yexp = _expert_ffn(params["experts"], xin, kind)
    if policy is not None:
        yexp = policy.ebuf_out(yexp)

    # ---- combine: slot (token, j) reads its expert row (a dropped slot the
    # zero row e·C) through the inverse of the sort; the k rows of a token
    # are summed in one fixed-order reduction.
    ysent = torch.cat([yexp.reshape(groups, e * cap, d), yexp.new_zeros((groups, 1, d))], 1)
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    contrib = ysent[gidx, slot_of].view(groups, tg, top_k, d) * gate_w.to(x.dtype)[..., None]
    out = contrib.sum(dim=2)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xf, kind)
    out = out.reshape(b, s, d)

    # Switch-style load-balancing aux loss: E * Σ_e f_e * P_e over every token
    load = counts.sum(0)
    psum = probs.sum(0)
    t_all = t
    if sharded:  # the other ranks' tokens: counts and router sums over the token axes
        groups_tok = [policy.group(a) for a in policy.token_axes()]
        for grp in groups_tok:
            load = all_reduce(load, grp)
        psum = policy.sum_tokens(psum)
        for a in policy.token_axes():
            t_all *= policy._size(a)
        p_e = psum / t_all
    else:
        p_e = probs.mean(dim=0)
    f_e = load.float() / (t_all * top_k)
    aux = e * torch.sum(f_e * p_e)
    if return_stats:
        stats = {
            "expert_load": load.to(torch.int32),
            "dropped_fraction": 1.0 - keep.float().mean(),
            "capacity": cap,
            "groups": groups,
            "gate_idx": gate_idx,
            "probs": probs,
        }
        return out, aux, stats
    return out, aux
