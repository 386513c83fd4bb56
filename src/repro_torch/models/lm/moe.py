"""Mixture-of-Experts with event-driven capacity dispatch.

The reference's ``repro/models/lm/moe.py`` on one device (one dispatch
group, no sharding policy). Token→expert routing is the same skewed
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
    """Stacked expert FFN: xin [E, C, D] -> [E, C, D]."""
    if kind == "swiglu":
        h = F.silu(torch.bmm(xin, experts["w_gate"])) * torch.bmm(xin, experts["w_up"])
        return torch.bmm(h, experts["w_down"])
    h = torch.bmm(xin, experts["w_in"])
    if kind == "relu2":
        h = torch.square(F.relu(h))
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return torch.bmm(h, experts["w_out"])


def moe_apply(params: Dict, x: torch.Tensor, *, num_experts: int, top_k: int, kind: str,
              capacity_factor: float = 1.25, return_stats: bool = False):
    """x [B, S, D] -> (out [B, S, D], aux) or, with ``return_stats``, (out,
    aux, stats): ``expert_load`` int32 [E] (slots routed to each expert),
    ``dropped_fraction`` (0-d f32, slots past capacity), ``capacity``,
    ``groups`` (1), and the routes ``gate_idx`` [T, k] with the router's
    ``probs`` f32 [T, E]. aux is the Switch loss E · Σ_e f_e · P_e."""
    b, s, d = x.shape
    t, e = b * s, num_experts
    cap = max(1, int(math.ceil(t * top_k / e * capacity_factor)))
    xf = x.reshape(t, d)

    # ---- route (f32)
    logits = xf.float() @ params["router"]  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # ---- schedule: sort the (token, k) slots by expert, rank, capacity
    flat_e = gate_idx.reshape(t * top_k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]  # sorted expert ids
    token_of = order // top_k
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * top_k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)  # overflow -> sentinel row

    # ---- dispatch / execute (only the sentinel row takes duplicate writes)
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = xf[token_of]
    yexp = _expert_ffn(params["experts"], buf[: e * cap].view(e, cap, d), kind)

    # ---- combine: slot (token, j) reads its expert row (a dropped slot the
    # zero row e·C) through the inverse of the sort; the k rows of a token
    # are summed in one fixed-order reduction.
    ysent = torch.cat([yexp.reshape(e * cap, d), yexp.new_zeros((1, d))])
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    contrib = ysent[slot_of].view(t, top_k, d) * gate_w.to(x.dtype)[..., None]
    out = contrib.sum(dim=1)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xf, kind)
    out = out.reshape(b, s, d)

    # Switch-style load-balancing aux loss: E * Σ_e f_e · P_e
    f_e = counts.float() / (t * top_k)
    p_e = probs.mean(dim=0)
    aux = e * torch.sum(f_e * p_e)
    if return_stats:
        stats = {
            "expert_load": counts.to(torch.int32),
            "dropped_fraction": 1.0 - keep.float().mean(),
            "capacity": cap,
            "groups": 1,
            "gate_idx": gate_idx,
            "probs": probs,
        }
        return out, aux, stats
    return out, aux
