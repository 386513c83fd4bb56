"""Mesh test cases of the port: one gloo rank per shard, in processes of their own.

``run_ranks`` writes nothing but starts ``world`` processes of this file
(``python _torch_mesh_cases.py <rank> <world> <dir>``), each with one CPU
thread. Each rank joins a gloo group through a ``file://`` store in ``dir``
(no TCP port, so test files may run in parallel), builds the 1-D
``("shard",)`` ``DeviceMesh``, runs every case of ``dir/inputs.pt`` through
the port's mesh backend and saves what it got to ``dir/rank<k>.pt``. The
group's timeout and the parent's deadline end the ranks of a dead or
deadlocked collective: ``run_ranks`` kills every rank and raises, so a test
fails instead of hanging the suite.

``run_case`` runs one case on a mesh, or with ``mesh=None`` through the host
loop, which the tests compare bit for bit. Nothing here imports JAX or the
reference package: the ranks import only the port.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4


# --------------------------------------------------------------- the cases
def _splan(case, modes):
    from repro_torch.core.message_passing import compile_sharded_plans

    return compile_sharded_plans(case["graph"], case["engine_cfg"], partition=case["partition"],
                                 modes=modes)


def run_case(case, mesh):
    """Outputs of one case: a dict of arrays and numbers."""
    from repro_torch.distributed.graph_shard import ShardedAmpleEngine
    from repro_torch.models.gnn import api as gnn_api

    kind = case["kind"]
    overlap = case.get("overlap", False)
    if kind == "gnn":  # the arch's forward on its prepared graph
        cfg = case["cfg"]
        eng = ShardedAmpleEngine(case["graph"], _splan(case, (gnn_api.agg_mode(cfg),)),
                                 mesh=mesh, halo_overlap=overlap)
        y = gnn_api.gnn_apply(cfg, case["params"], eng, torch.from_numpy(case["x"]))
        return dict(y=y.numpy(), **eng.halo_stats)
    if kind == "coeff":  # a raw f32[E] runtime coefficient
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("runtime",)), mesh=mesh,
                                 halo_overlap=overlap)
        y = eng.aggregate(torch.from_numpy(case["x"]), mode="runtime",
                          edge_coeff=torch.from_numpy(case["coeff"]))
        return dict(y=y.numpy(), **eng.halo_stats)
    if kind == "train":  # the arch's loss under grad: the output, every gradient
        cfg = case["cfg"]
        eng = ShardedAmpleEngine(case["graph"], _splan(case, (gnn_api.agg_mode(cfg),)),
                                 mesh=mesh, halo_overlap=overlap)
        params = _tree_map(lambda t: t.detach().clone().requires_grad_(), case["params"])
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = gnn_api.gnn_apply(cfg, params, eng, x)
        return _grads(y, [x] + _leaves(params), case["r"], case.get("die_before_backward"))
    if kind == "train-coeff":  # a raw f32[E] runtime coefficient and the rows under grad
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("runtime",)), mesh=mesh,
                                 halo_overlap=overlap)
        x = torch.from_numpy(case["x"]).requires_grad_()
        coeff = torch.from_numpy(case["coeff"]).requires_grad_()
        y = eng.aggregate(x, mode="runtime", edge_coeff=coeff)
        return _grads(y, [x, coeff], case["r"])
    if kind == "train-scale":  # the int8 group's scale as a leaf: its gradient, and the rows'
        eng = ShardedAmpleEngine(case["graph"], _splan(case, ("sum",)), mesh=mesh,
                                 halo_overlap=overlap)
        from repro_torch.core.quantization import compute_scale_zp

        x = torch.from_numpy(case["x"]).requires_grad_()
        qp = compute_scale_zp(x.detach(), symmetric=True)
        scale = qp.scale.clone().requires_grad_()
        eng._activation_qp = lambda *a, **kw: type(qp)(scale, qp.zero_point)
        y = eng.aggregate(x, mode="sum")
        return _grads(y, [x, scale], case["r"])
    if kind == "front":
        return _front(case, mesh)
    if kind.startswith("lm-"):
        return _lm_case(case, mesh)
    if kind == "serve":  # GNNServeEngine: cold, warm (after a plan cache load)
        from repro_torch.serve.gnn_engine import GNNServeEngine

        srv = GNNServeEngine(case["cfg"], case["params"], num_shards=WORLD,
                             partitioner=case["partitioner"], halo_overlap=overlap, mesh=mesh,
                             device="cpu")
        loaded = srv.load_plan_cache(case["plan_dir"]) if case.get("plan_dir") else 0
        rs = [srv.infer(case["graph"], case["x"]) for _ in range(2)]
        return dict(y=[r.outputs for r in rs], cache_hit=[r.cache_hit for r in rs],
                    plan_ms=[r.plan_ms for r in rs], halo_bytes=[r.halo_bytes for r in rs],
                    num_shards=[r.num_shards for r in rs], loaded=loaded,
                    planner_calls=srv.stats["planner_calls"])
    raise ValueError(f"unknown case kind {kind!r}")


def _front(case, mesh):
    """A request stream through ``AsyncGNNEngine`` or a two-tenant
    ``TenantRouter`` (``case["front"]``) over a sharded GNNServeEngine, on a
    mesh or (``mesh`` None) the host loop: ``case["runs"]`` drains of the
    same stream (cold, then warm). On the mesh, rank ``case["late"]``
    submits from a thread, ``delay_s`` apart, while it drains; with
    ``case["stop"]`` it submits only the first ``stop`` requests (a stuck
    follower), and the rest after the drain. Each run: the windows served
    (node counts of their members), each request's output or error, the
    router's ``window_log``."""
    import threading

    from repro_torch.serve.async_gnn import AsyncGNNEngine
    from repro_torch.serve.gnn_engine import GNNServeEngine
    from repro_torch.serve.tenancy.router import TenantRouter

    srv = GNNServeEngine(case["cfg"], case["params"], num_shards=WORLD, partitioner="edges",
                         mesh=mesh, device="cpu")
    windows, infer_batch = [], srv.infer_batch

    def logged(requests):
        windows.append([r.graph.num_nodes for r in requests])
        return infer_batch(requests)

    srv.infer_batch = logged
    front = AsyncGNNEngine(srv, window=case["window"])
    if case["front"] == "router":
        front = TenantRouter(front)
        front.add_tenant("gold", weight=2.0, priority=1)
        front.add_tenant("batch", weight=1.0)
    rank = 0 if mesh is None else mesh.get_local_rank("shard")
    late = mesh is not None and rank == case.get("late")
    stop = case.get("stop") if late else None
    requests = case["requests"]

    def submit(items, tickets, delay=0.0):
        for i, (tenant, g, x) in items:
            time.sleep(delay)
            tickets[i] = (front.submit(tenant, g, x) if case["front"] == "router"
                          else front.submit(g, x))

    def outcome(t):
        return type(t.error).__name__ if t.error is not None else t.response.outputs

    runs = []
    for _ in range(case["runs"]):
        del windows[:]
        tickets = {}
        items = list(enumerate(requests))[:stop]
        if late:
            th = threading.Thread(target=submit, args=(items, tickets, case["delay_s"]))
            th.start()
        else:
            submit(items, tickets)
        if case.get("fault") == rank:
            time.sleep(3600)
        front.drain()
        if late:
            th.join()
        submit(list(enumerate(requests))[len(items):], tickets)  # a stuck rank's rest
        runs.append(dict(windows=list(windows),
                         results=[outcome(tickets[i]) for i in range(len(requests))],
                         done=[tickets[i].done for i in range(len(requests))],
                         window_log=list(getattr(front, "window_log", []))))
    return dict(runs=runs, stats=dict(front.stats))


# ------------------------------------------------------ the LM on a 2x2 mesh
def _lm_case(case, mesh):
    """An LM case on the ("data", "model") = (2, 2) mesh, or (``mesh`` None)
    through the unsharded port: each case twice, its outputs made whole
    (numpy) so the parent compares them with either side."""
    from repro_torch.distributed import sharding as sh

    pol = sh.NO_POLICY if mesh is None else sh.make_policy(mesh, mode=case.get("mode", "tp"))
    fsdp_min = sh.FSDP_MIN_ELEMENTS
    if case.get("fsdp_min") is not None:
        sh.FSDP_MIN_ELEMENTS = case["fsdp_min"]
    try:
        run = {"lm-train": _lm_train, "lm-decode": _lm_decode, "lm-moe": _lm_moe,
               "lm-cmm": _lm_cmm, "lm-cp": _lm_cp, "lm-engines": _lm_engines,
               "lm-serve": _lm_serve, "lm-compress": _lm_compress,
               "lm-ckpt": _lm_ckpt}[case["kind"]]
        return dict(runs=[run(case, mesh, pol) for _ in range(case.get("runs", 2))])
    finally:
        sh.FSDP_MIN_ELEMENTS = fsdp_min


def _whole(x, pol, batch_axes, vocab_dim=None):
    """A rank's block made whole: the vocab over "model" (when ``vocab_dim``
    is given), then the batch over its axes, inner first."""
    from repro_torch.distributed.sharding import all_gather

    if vocab_dim is not None:
        x = torch.cat(all_gather(x, pol.group("model")), vocab_dim)
    for a in reversed(batch_axes):
        x = torch.cat(all_gather(x, pol.group(a)), 0)
    return x


def _lm_train(case, mesh, pol):
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import _leaves
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg, params = case["cfg"], case["params"]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if mesh is not None:
        pl = sh.param_shardings(cfg, params, mesh, mode=pol.mode)
        params = sh.shard_tree(params, pl, mesh)
        pol = pol.with_placements(pl)
    new, m = make_train_step(cfg, policy=pol)(init_train_state(cfg, params), batch)
    out = new["params"] if mesh is None else sh.gather_tree(new["params"], pl, mesh)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=[t.detach().numpy() for t in _leaves(out)])


def _lm_engines(case, mesh, pol):
    """``ServeEngine.generate`` (every rank's tokens of the whole batch) and
    two ``Trainer`` steps (the params made whole) under the policy."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.optim.adamw import _leaves
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg, params = case["cfg"], case["params"]
    kw = {} if mesh is None else {"policy": pol}
    serve_kw = dict(kw)
    if mesh is not None:
        pl = sh.param_shardings(cfg, params, mesh, fsdp=False, mode=pol.mode)
        params = sh.shard_tree(params, pl, mesh)
        serve_kw["policy"] = pol.with_placements(pl)
    toks = ServeEngine(cfg, params, max_len=case["max_len"], device="cpu", **serve_kw).generate(
        torch.from_numpy(case["prompt"]), max_new_tokens=case["new"])
    trainer = Trainer(cfg, TrainerConfig(steps=2, batch=8, seq=16, log_every=1), device="cpu",
                      **kw)
    out = trainer.run()
    p = out["state"]["params"]
    if mesh is not None:
        p = sh.gather_tree(p, trainer.policy.placements, mesh)
    return dict(tokens=toks.numpy(), loss=[m["loss"] for m in out["metrics"]],
                params=[t.detach().numpy() for t in _leaves(p)])


def _by_spec(x, spec, pol):
    """A rank's block of a tensor laid out by ``spec`` (per dim, the mesh
    axes over it, outer first) made whole: inner axes first."""
    from repro_torch.distributed.sharding import all_gather

    for d, axes in enumerate(spec):
        for a in reversed(axes):
            x = torch.cat(all_gather(x.contiguous(), pol.group(a)), d)
    return x


def _logits(lg, pol, b, s, cfg, mesh):
    """Logits [B', S', V'] (or [B', V'] with ``s`` None) made whole."""
    if mesh is None:
        return lg.detach().numpy()
    spec = pol.bind(b, s or 1).compute_spec()[:1 if s is None else 2]
    vocab = ("model",) if lg.shape[-1] != cfg.padded_vocab(1) else ()
    return _by_spec(lg.detach(), spec + (vocab,), pol).numpy()


def _cache(cache, cfg, pol, b, length, src_len, mesh):
    """Every cache leaf made whole (numpy), in leaf order."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm.transformer import init_cache

    if mesh is None:
        return [t.numpy().copy() for t in _leaves(cache)]
    if isinstance(cache, dict):  # the enc-dec cache
        kv = (cfg.num_layers, b, length, cfg.num_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv, "cross_k": kv[:2] + (src_len,) + kv[3:]}
        shapes["cross_v"] = shapes["cross_k"]
    else:
        shapes = init_cache(cfg, b, length, device="meta")
    pl = sh.cache_shardings(cfg, shapes, mesh, batch=b)
    return [t.numpy().copy() for t in _leaves(sh.gather_tree(cache, pl, mesh))]


def _lm_serve(case, mesh, pol):
    """``model_forward``, ``model_prefill`` (logits, every cache leaf) and
    ``model_decode_step``s on given tokens (or embeds), all made whole. The
    enc-dec decodes from ``model_init_cache`` (its prefill leaves the
    self-attention cache empty). No ``steps``: forward and prefill only."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api

    cfg, params = case["cfg"], case["params"]
    if mesh is not None:
        pl = sh.param_shardings(cfg, params, mesh, fsdp=case.get("fsdp", False), mode=pol.mode)
        params = sh.shard_tree(params, pl, mesh)
        pol = pol.with_placements(pl)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    encdec = "src_embeds" in batch
    lead = batch["tgt_tokens"] if encdec else batch.get("tokens", batch.get("embeds"))
    b, s = lead.shape[:2]
    src_len = batch["src_embeds"].shape[1] if encdec else None
    length = case["max_len"]
    out = {}
    with torch.no_grad():
        lg, aux = api.model_forward(params, cfg, batch, policy=pol)
        out["forward"], out["aux"] = _logits(lg, pol, b, s, cfg, mesh), float(aux)
        lg, cache, n = api.model_prefill(params, cfg, batch, length, policy=pol)
        out["prefill"] = _logits(lg, pol, b, s, cfg, mesh)
        out["prefill_cache"] = _cache(cache, cfg, pol, b, length, src_len, mesh)
        out["cache_shapes"] = [tuple(t.shape) for t in _leaves(cache)]
        if encdec:
            cache = api.model_init_cache(cfg, params, batch, length, policy=pol)
            n = 0
        steps = []
        for i, step in enumerate(case["steps"]):
            lg, cache = api.model_decode_step(params, cfg, {k: torch.from_numpy(v)
                                                            for k, v in step.items()},
                                              cache, n + i, policy=pol)
            steps.append(_logits(lg, pol, b, None, cfg, mesh))
        out["steps"] = steps
        if steps:
            out["decode_cache"] = _cache(cache, cfg, pol, b, length, src_len, mesh)
    return out


class _Recording:
    """A compressor that keeps what each call was given and returned."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def init_state(self, grads):
        return self.inner.init_state(grads)

    def compress_decompress(self, grads, state, **kw):
        out = self.inner.compress_decompress(grads, state, **kw)
        self.calls.append((grads, state, out))
        return out


def _compressor(case):
    from repro_torch.distributed.compression import Int8Compressor, TopKCompressor

    return (TopKCompressor(ratio=case["ratio"]) if case["compress"] == "topk"
            else Int8Compressor(seed=case["seed"]))


def _lm_compress(case, mesh, pol):
    """One ``make_train_step(cfg, compressor=, policy=)`` step: the
    gradients the compressor was given, its state, what it sent and its new
    state, the new params, the loss and grad norm, all whole."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg, params = case["cfg"], case["params"]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    if mesh is not None:
        pl = sh.param_shardings(cfg, params, mesh, mode=pol.mode)
        params = sh.shard_tree(params, pl, mesh)
        pol = pol.with_placements(pl)
    comp = _Recording(_compressor(case))
    state = init_train_state(cfg, params)
    state["compress"] = comp.init_state(params)
    new, m = make_train_step(cfg, compressor=comp, policy=pol)(state, batch)
    (grads, err, (sent, new_err)), = comp.calls

    def whole(tree):
        if mesh is not None:
            tree = sh.gather_tree(tree, pl, mesh)
        return [t.detach().numpy().copy() for t in _leaves(tree)]

    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                grads=whole(grads), err=whole(err), sent=whole(sent), new_err=whole(new_err),
                params=whole(new["params"]), state_err=whole(new["compress"]))


def _lm_ckpt(case, mesh, pol):
    """Checkpoints of a Trainer (``case["steps"]`` steps, a compressor's
    error feedback in the state): on a mesh, a run that crashes after step
    ``crash`` (async saves) and its resume, beside an uninterrupted run;
    the mesh checkpoint at ``crash`` resumed by an unsharded Trainer; an
    unsharded run's checkpoint resumed on the mesh. Unsharded (``mesh``
    None): the uninterrupted run. Params made whole."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = case["cfg"]
    case["_run"] = case.get("_run", 0) + 1
    root = os.path.join(case["dir"], f"run{case['_run']}")

    def tcfg(**kw):
        return TrainerConfig(steps=case["steps"], batch=case["batch"], seq=case["seq"],
                             log_every=1, ckpt_every=1, compressor=_compressor(case), **kw)

    def params(out, trainer):
        p = out["state"]["params"]
        if on:
            p = sh.gather_tree(p, trainer.policy.placements, mesh)
        return [t.detach().numpy().copy() for t in _leaves(p)]

    on = mesh is not None
    kw = {"policy": pol} if on else {}
    straight = Trainer(cfg, tcfg(), device="cpu", **kw)
    res = dict(straight=params(straight.run(), straight))
    if not on:
        return res
    rank = dist.get_rank()
    mesh_dir, plain_dir = os.path.join(root, "mesh"), os.path.join(root, "plain")
    try:
        Trainer(cfg, tcfg(ckpt_dir=mesh_dir, ckpt_async=True), device="cpu",
                policy=pol).run(crash_at=case["crash"])
    except RuntimeError as e:
        assert "injected fault" in str(e)
    ckpt.wait_pending()  # rank 0's writer thread, before any rank reads
    dist.barrier()
    # each rank resumes its own copy of the mesh checkpoint unsharded
    mine = os.path.join(root, f"unsharded{rank}")
    shutil.copytree(os.path.join(mesh_dir, f"step_{case['crash']:09d}"),
                    os.path.join(mine, f"step_{case['crash']:09d}"))
    dist.barrier()
    resumed = Trainer(cfg, tcfg(ckpt_dir=mesh_dir), device="cpu", policy=pol)
    res["resumed"] = params(resumed.run(), resumed)
    plain = Trainer(cfg, tcfg(ckpt_dir=mine), device="cpu")
    res["mesh_to_plain"] = [t.detach().numpy().copy() for t in _leaves(plain.run()["state"]["params"])]
    if rank == 0:
        try:
            Trainer(cfg, tcfg(ckpt_dir=plain_dir), device="cpu").run(crash_at=case["crash"])
        except RuntimeError as e:
            assert "injected fault" in str(e)
    dist.barrier()
    onto = Trainer(cfg, tcfg(ckpt_dir=plain_dir), device="cpu", policy=pol)
    res["plain_to_mesh"] = params(onto.run(), onto)
    res["files"] = sorted(os.listdir(mesh_dir))
    return res


def _lm_decode(case, mesh, pol):
    """Decode at 0 from an empty cache (the reference's test), then prefill
    and two greedy steps: every step's logits, whole."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api

    cfg, params = case["cfg"], case["params"]
    if mesh is not None:
        pl = sh.param_shardings(cfg, params, mesh, fsdp=False, mode=pol.mode)
        params = sh.shard_tree(params, pl, mesh)
        pol = pol.with_placements(pl)
    vp = cfg.padded_vocab(1)

    def whole(lg, b):
        if mesh is None:
            return lg.numpy()
        return _whole(lg, pol, pol.bind(b, 1).compute_spec()[0],
                      -1 if lg.shape[-1] != vp else None).numpy()

    ones = {"tokens": torch.ones((case["batch"], 1), dtype=torch.int64)}
    with torch.no_grad():
        cache = api.model_init_cache(cfg, params, ones, case["max_len"], policy=pol)
        at0 = whole(api.model_decode_step(params, cfg, ones, cache, 0, policy=pol)[0],
                    case["batch"])
        prompt = torch.from_numpy(case["prompt"])
        b = prompt.shape[0]
        lg, cache, n = api.model_prefill(params, cfg, {"tokens": prompt}, case["max_len"],
                                         policy=pol)
        steps = []
        tok = (torch.argmax(lg[:, -1], -1) if mesh is None
               else pol.bind(b, 1).greedy(lg[:, -1], vp, vp))
        for i in range(2):
            lg, cache = api.model_decode_step(params, cfg, {"tokens": tok[:, None]}, cache,
                                              n + i, policy=pol)
            steps.append(whole(lg, b))
            tok = (torch.argmax(lg, -1) if mesh is None else pol.bind(b, 1).greedy(lg, vp, vp))
    return dict(at0=at0, steps=steps, cache_shape=tuple(cache[0]["k"].shape))


def _lm_moe(case, mesh, pol):
    """``moe_apply_sharded`` (or the port's plain layer) of a swiglu MoE:
    the output and the gradients of sum(out * r), whole."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as sh
    from repro_torch.models.lm.moe import moe_apply
    from repro_torch.models.lm.moe_sharded import moe_apply_sharded

    params, e = case["params"], case["e"]
    x, r = torch.from_numpy(case["x"]), torch.from_numpy(case["r"])
    kw = dict(num_experts=e, top_k=case["k"], kind="swiglu",
              capacity_factor=case["capacity_factor"])
    if mesh is not None:
        ep = e % pol.tp == 0
        rep, col, row = (Replicate(), Replicate()), (Replicate(), Shard(1)), (Replicate(), Shard(0))
        pl = {"router": rep,
              "experts": {k: row if ep else rep for k in params["experts"]}}
        if "shared" in params:
            pl["shared"] = {k: row if k == "w_down" else col for k in params["shared"]}
        params = sh.shard_tree(params, pl, mesh)
        bound = pol.bind(x.shape[0], x.shape[1])
        x, r = bound.take(x, (("data",),)), bound.take(r, (("data",),))
    flat = _leaves(params)
    x = x.clone().requires_grad_()
    live = [t.clone().requires_grad_() for t in flat]
    it = iter(live)
    tree = _rebuild_like(params, it)
    if mesh is None:
        out, aux = moe_apply(tree, x, **kw)
    else:
        out, aux = moe_apply_sharded(tree, x, policy=pol, **kw)
    grads = torch.autograd.grad((out * r).sum(), [x] + live)
    if mesh is None:
        return dict(out=out.detach().numpy(), aux=float(aux.detach()),
                    grads=[g.numpy() for g in grads])
    from repro_torch.distributed.sharding import all_reduce

    gx = _whole(grads[0], pol, ("data",))
    gp = _rebuild_like(params, iter(all_reduce(g, pol.group("data")) for g in grads[1:]))
    whole = sh._map(lambda _, g, place: _unshard(g, place, pol), gp, pl)
    return dict(out=_whole(out.detach(), pol, ("data",)).numpy(), aux=float(aux.detach()),
                grads=[gx.numpy()] + [g.numpy() for g in _leaves(whole)])


def _unshard(g, place, pol):
    from repro_torch.distributed.sharding import all_gather

    d = place[1]
    return g if not hasattr(d, "dim") else torch.cat(all_gather(g, pol.group("model")), d.dim)


def _rebuild_like(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild_like(tree[k], it) for k in sorted(tree)}
    return next(it)


def _lm_cmm(case, mesh, pol):
    """The collective matmuls on the model axis, made whole; the unsharded
    side is x @ w."""
    from repro_torch.distributed.collective_matmul import allgather_matmul, reduce_scatter_matmul

    x, w = torch.from_numpy(case["x"]), torch.from_numpy(case["w"])
    if mesh is None:
        y = (x @ w).numpy()
        return dict(ag=y, rs=y)
    n, c = pol.tp, pol._coord("model")
    m, k, nn = x.shape[0], x.shape[1], w.shape[1]
    ag = allgather_matmul(x[c * m // n:(c + 1) * m // n], w[:, c * nn // n:(c + 1) * nn // n],
                          mesh)
    rs = reduce_scatter_matmul(x[:, c * k // n:(c + 1) * k // n],
                               w[c * k // n:(c + 1) * k // n], mesh)
    from repro_torch.distributed.sharding import all_gather

    return dict(ag=torch.cat(all_gather(ag, pol.group("model")), 1).numpy(),
                rs=torch.cat(all_gather(rs, pol.group("model")), 0).numpy(),
                ag_local=tuple(ag.shape), rs_local=tuple(rs.shape))


def _lm_cp(case, mesh, pol):
    """Context-parallel causal attention through the ``qkv`` hook: this
    rank's heads in, its sequence rows of every head out, K/V cut; the
    output and the q/k/v gradients of sum(out * r), whole."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, r = (torch.from_numpy(case[n]) for n in ("q", "k", "v", "r"))
    if mesh is None:
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        out = fa_ops.flash_attention(q, k, v, causal=True)
        g = torch.autograd.grad((out * r).sum(), [q, k, v])
        return dict(out=out.detach().numpy(), grads=[t.numpy() for t in g])
    b, s = q.shape[:2]
    bound = pol.bind(b, s)
    src = (("data",), (), ("model",), ())
    q, k, v = (bound.take(t, src).contiguous().requires_grad_() for t in (q, k, v))
    qd, kd, vd = bound.qkv(q, k, v, src, causal=True)
    out = fa_ops.flash_attention(qd, kd, vd, causal=True)
    g = torch.autograd.grad((out * bound.take(r, bound.q_spec())).sum(), [q, k, v])
    whole_out = _whole(torch.cat(_gather_model(out.detach(), pol), 1), pol, ("data",))
    grads = [_whole(torch.cat(_gather_model(t, pol), 2), pol, ("data",)) for t in g]
    return dict(out=whole_out.numpy(), grads=[t.numpy() for t in grads],
                kv_shape=tuple(kd.shape), kv_contiguous=kd.is_contiguous() and vd.is_contiguous(),
                q_shape=tuple(qd.shape))


def _gather_model(t, pol):
    from repro_torch.distributed.sharding import all_gather

    return all_gather(t.contiguous(), pol.group("model"))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    """The tensors of a params tree, keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _grads(y, inputs, r, die=False):
    """The output and the gradients of ``sum(y * r)`` (None: unused);
    ``die``: the process exits before the backward."""
    loss = (y * torch.from_numpy(r)).sum()
    if die:
        os._exit(3)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return dict(y=y.detach().numpy(), grads=[None if g is None else g.numpy() for g in grads])


# ------------------------------------------------------------- the parent
def run_ranks(directory: str, *, deadline_s: float = 120.0, world: int = WORLD):
    """Start the ranks on ``directory/inputs.pt``; return each rank's outputs.

    Raises if a rank exits non-zero (the others are killed at once) or the
    deadline passes (every rank is killed)."""
    return wait_ranks(start_ranks(directory, world=world), deadline_s=deadline_s)


def start_ranks(directory: str, *, world: int = WORLD):
    """The rank processes on ``directory/inputs.pt``, started; the caller
    may work while they run, then ``wait_ranks``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               directory], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    return dict(procs=procs, directory=directory, t0=time.monotonic())


def wait_ranks(started, *, deadline_s: float = 120.0):
    """Each started rank's outputs (``run_ranks``' checks; the deadline
    counts from the start)."""
    procs, directory = started["procs"], started["directory"]
    t_end = started["t0"] + deadline_s
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} failed: {procs[bad[0]].communicate()[0]}")
            if time.monotonic() > t_end:
                raise TimeoutError(f"the ranks passed their {deadline_s:.0f} s deadline")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} failed: {procs[bad[0]].communicate()[0]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


# --------------------------------------------------------------- a rank
def rank_main(rank: int, world: int, directory: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    fault = spec.get("fault", {})
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(directory, 'store')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=spec.get("timeout_s", 60)))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shard",))
    # the LM cases' (data, model) mesh over the same group
    lm_mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
    if fault.get(rank) == "die":
        raise SystemExit(3)
    if fault.get(rank) == "hang":
        time.sleep(3600)
    for c in spec["cases"]:  # a fault inside a case: rank k dies in backward, or hangs in a window
        if fault.get(rank) == "die-backward":
            c["die_before_backward"] = True
        if fault.get(rank) == "hang-window":
            c["fault"] = rank
    out = {c["name"]: run_case(c, lm_mesh if c["kind"].startswith("lm-") else mesh)
           for c in spec["cases"]}
    out["_rank"] = mesh.get_local_rank("shard")
    out["_backend"] = dist.get_backend(mesh.get_group("shard"))
    out["_foreign"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
