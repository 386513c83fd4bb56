"""The MoE layer over a mesh: explicit expert-parallel dispatch.

The reference's ``repro/models/lm/moe_sharded.py`` (its ``shard_map``
schedule), on local tensors and ``torch.distributed`` groups. Every data
shard runs its own nodeslot pool (local sort, rank and capacity: no traffic
between shards), and each model rank runs only its slice of the experts
against the tokens it already holds, replicated over "model"; one
all-reduce over "model" assembles the combine, the layer's only activation
collective. Two variants:

* EP (experts % model axis == 0): model rank m owns experts
  ``[m·E/tp, (m+1)·E/tp)``; the schedule is the same on every model rank
  (cheaper than broadcasting it), each rank dispatches only its own
  experts' slots, and the shared expert, column-parallel over its hidden
  dim, is folded into the same sum;
* replicated experts (any expert count, e.g. Granite's 40 on a 3-way axis):
  the tokens split over "model" as well and every rank runs its own pool
  against all the experts (gathered over "data"), with no activation
  collective but the gather of its tokens' outputs.

The aux loss is the whole batch's, as on one device: the expert counts and
the router's probability sums are summed over the token shards. FSDP expert
weights arrive gathered (``ShardingPolicy.gather_params``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.distributed.sharding import _G, _Gather, _Slice, all_reduce, on_mesh
from repro_torch.models.lm.mlp import mlp_apply
from repro_torch.models.lm.moe import _expert_ffn

__all__ = ["moe_apply_sharded", "sharded_applicable"]


def sharded_applicable(policy, num_experts: int, t: int, d_ff: int) -> bool:
    """A mesh policy in ``tp`` mode and divisible tokens: EP (experts %
    model axis == 0), or the replicated-expert variant where this rank's
    ``t`` tokens split over the model axis."""
    if not on_mesh(policy) or policy.mode != "tp":
        return False
    tp = policy.tp
    return num_experts % tp == 0 or t % tp == 0


def moe_apply_sharded(params: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
                      kind: str, capacity_factor: float, policy):
    """x [B, S, D], this data shard's tokens replicated over "model" ->
    (out [B, S, D] replicated over "model", the whole batch's aux). ``params["experts"]`` holds this rank's experts (EP: E/tp of
    them)."""
    b, s, d = x.shape
    t, e, tp = b * s, num_experts, policy.tp
    ep = e % tp == 0
    e_loc = e // tp if ep else e
    experts = params["experts"]
    if experts[next(iter(experts))].shape[0] != e_loc:
        raise ValueError(f"expected {e_loc} local experts, got "
                         f"{experts[next(iter(experts))].shape[0]}")
    has_shared = "shared" in params
    if not ep and has_shared:
        raise NotImplementedError("replicated-expert path w/ shared expert")
    model = policy.group("model")
    xf = x.reshape(t, d)
    router = params["router"]
    if not ep:  # this rank's tokens of the data shard; its weights' gradient is partial
        xf = _Slice.apply(xf, model, 0)
        router = policy.colpar(router)
        experts = {k: policy.colpar(w) for k, w in experts.items()}
    t_loc = xf.shape[0]
    cap = max(1, int(math.ceil(t_loc * top_k / e * capacity_factor)))

    # ---- route (f32), the same on every model rank in EP
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # ---- the local nodeslot schedule
    flat_e = gate_idx.reshape(t_loc * top_k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    token_of = order // top_k
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t_loc * top_k, device=x.device) - starts[se]
    keep = rank < cap
    if ep:  # my expert slice only; the combine of the others' comes in the all-reduce
        lo = policy._coord("model") * e_loc
        mine = keep & (se >= lo) & (se < lo + e_loc)
        slot = torch.where(mine, (se - lo) * cap + rank, e_loc * cap)
        xd = policy.colpar(xf)
        gate_w = policy.colpar(gate_w)
    else:
        slot = torch.where(keep, se * cap + rank, e_loc * cap)
        xd = xf

    buf = x.new_zeros((e_loc * cap + 1, d))
    buf[slot] = xd[token_of]
    yexp = _expert_ffn(experts, buf[: e_loc * cap].view(1, e_loc, cap, d), kind)[0]
    ysent = torch.cat([yexp.reshape(e_loc * cap, d), yexp.new_zeros((1, d))])
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    out = (ysent[slot_of].view(t_loc, top_k, d) * gate_w.to(x.dtype)[..., None]).sum(dim=1)

    if ep:
        shared_tp = has_shared and _hidden(params["shared"]) != _hidden(params["experts"])
        if shared_tp:  # column-parallel shared expert: a partial sum over its hidden dim
            out = out + mlp_apply(params["shared"], xd, kind)
        out = policy.rowpar(out)
        if has_shared and not shared_tp:
            out = out + mlp_apply(params["shared"], xf, kind)
    else:
        out = _Gather.apply(out, model, 0, False)

    # load-balance aux over every token, as on one device: the expert counts
    # and the router's probability sums added up over the token shards
    axes = policy.token_axes() + (() if ep else ("model",))
    groups = tuple(policy.group(a) for a in axes)
    n = t_loc
    for a in axes:
        n *= policy._size(a)
    total = counts.float()
    for grp in groups:
        total = all_reduce(total, grp)
    aux = e * torch.sum(total / (n * top_k) * (_G.apply(probs.sum(dim=0), groups) / n))
    return out.reshape(b, s, d), aux


def _hidden(mlp: Dict) -> int:
    w = mlp["w_gate"] if "w_gate" in mlp else mlp["w_in"]
    return int(w.shape[-1])
