"""The port's mesh backend of the sharded GNN engine, in 4 gloo ranks on the CPU.

One module fixture writes every case's inputs, starts 4 rank processes once
(``_torch_mesh_cases.run_ranks``: one CPU thread each, a ``file://`` store,
a group timeout and a deadline) and reads back what each rank returned; the
parametrised tests compare. Citeseer-sized graphs and REDUCED widths, as the
reference's mesh tests (``tests/test_distributed.py:133-244``): gcn, gin and
sage (mixed) under ``edges`` and ``mincut``, with and without
``halo_overlap``; a raw f32[E] runtime coefficient and GAT with 2 heads. The
mesh output must be bitwise the port's host loop on every rank; the host
loop is held against the reference's at ``tests/test_torch_sharded.py``'s
tolerances. The serving engine on a mesh: warm == cold, and a plan cache a
host-loop engine saved loads as a hit. Training on a mesh: every gradient
(the params, the input, a runtime coefficient, the int8 scale) bitwise the
host loop's (which ``tests/test_torch_train_sharded.py`` holds against the
reference's ``jax.grad``) and the same on every rank. The fronts on a mesh:
rank 0's windows on every rank, one rank's submissions late, bitwise the
same fronts over the host loop, each tenant's order kept, warm == cold, and
a stuck follower failing its windows on every rank. The refusals need no
process group.

The same ranks run the LM on a second mesh, (data, model) = (2, 2), over the
same group: REDUCED qwen3-8b train steps (``tp``, ``fsdp``, FSDP on every
leaf, ``remat="block"``) against the reference's single-device step and the
unsharded port; REDUCED qwen2-1.5b decoding over a sharded cache;
``ServeEngine`` and ``Trainer`` under the policy; ``moe_apply_sharded`` (EP
and replicated experts) with its gradients; the ring collective matmuls
against the reference's on a faked 2x2 mesh (a JAX subprocess run while the
ranks do); context-parallel attention through the ``qkv`` hook. Each case
runs twice in every rank: the same bits on every rank and in both runs.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_cases as cases
from _torch_parity import assert_mixed_close, cfg_pair, params_pair
from repro.core import message_passing as ref_mp
from repro.distributed import graph_shard as ref_shard
from repro.graphs import datasets as ref_ds
from repro.graphs import partition as ref_part
from repro.models.gnn import api as ref_api
from repro_torch.core import message_passing as port_mp
from repro_torch.distributed.graph_shard import ShardedAmpleEngine, build_mesh_state
from repro_torch.graphs import datasets as port_ds
from repro_torch.graphs import partition as port_part
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.gnn_engine import GNNServeEngine
from repro_torch.configs.base import get_config as port_config
from repro_torch.models import api as port_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = ["edges", "mincut"]
ARCHS = ["gcn", "gin", "sage"]
GNN_KW = dict(d_model=20, d_ff=12, vocab_size=6, gnn_precision="mixed", gnn_edges_per_tile=64)
GAT_KW = dict(d_model=24, d_ff=16, vocab_size=8, gnn_precision="mixed", gnn_edges_per_tile=64,
              gnn_heads=2)


def _graphs(nodes, seed, dim):
    kw = dict(max_nodes=nodes, max_feature_dim=dim, seed=seed)
    return ref_ds.make_dataset("citeseer", **kw), port_ds.make_dataset("citeseer", **kw)


def _models():
    """name -> (reference cfg, port cfg, reference params, port params, raw graphs)."""
    out = {}
    for arch in ARCHS + ["gat"]:
        rcfg, pcfg = cfg_pair(arch, **(GAT_KW if arch == "gat" else GNN_KW))
        graphs = _graphs(150, 3, 24) if arch == "gat" else _graphs(180, 4, 20)
        out[arch] = (rcfg, pcfg, *params_pair(rcfg, pcfg, seed=0), graphs)
    return out


def _case_list(models, plan_dir):
    """Every case the ranks run (and the host loop runs in this process)."""
    out = []
    for arch in ARCHS + ["gat"]:
        _, pcfg, _, pp, (_, pg) = models[arch]
        prepared = port_api.prepare_graph(pcfg, pg)
        for kind in KINDS:
            part = port_part.make_partition(prepared, cases.WORLD, kind)
            base = dict(graph=prepared, engine_cfg=port_api.engine_config(pcfg), partition=part,
                        x=pg.features)
            r = np.random.default_rng(5).standard_normal(
                (prepared.num_nodes, pcfg.gnn_layer_dims[-1])).astype(np.float32)
            rx = np.random.default_rng(6).standard_normal(pg.features.shape).astype(np.float32)
            for overlap in (False, True):
                out.append(dict(base, name=f"gnn-{arch}-{kind}-{overlap}", kind="gnn", cfg=pcfg,
                                params=pp, overlap=overlap))
                # training runs unsplit: the host loop's overlap=False gradients hold both
                out.append(dict(base, name=f"train-{arch}-{kind}-{overlap}", kind="train",
                                cfg=pcfg, params=pp, overlap=overlap, r=r, host=not overlap))
            if arch == "gat":
                coeff = np.random.default_rng(0).standard_normal(prepared.num_edges).astype(
                    np.float32)
                for overlap in (False, True):
                    out.append(dict(base, name=f"coeff-{kind}-{overlap}", kind="coeff",
                                    coeff=coeff, overlap=overlap))
                out.append(dict(base, name=f"train-coeff-{kind}", kind="train-coeff",
                                coeff=coeff, r=rx))
            if arch == "gcn":
                out.append(dict(base, name=f"train-scale-{kind}", kind="train-scale", r=rx))
    for arch, overlap, warm in (("gcn", False, False), ("gcn", True, True),
                                ("gat", True, False)):
        _, pcfg, _, pp, (_, pg) = models[arch]
        out.append(dict(name=f"serve-{arch}-{overlap}-{warm}", kind="serve", cfg=pcfg, params=pp,
                        graph=pg, x=pg.features, partitioner="edges", overlap=overlap,
                        plan_dir=plan_dir if warm else None))
    _, pcfg, _, pp, _ = models["gcn"]
    front = dict(kind="front", cfg=pcfg, params=pp, requests=_front_requests(), window=2,
                 delay_s=0.05, late=LATE)
    out += [dict(front, name="front-async", front="async", runs=2),
            dict(front, name="front-router", front="router", runs=2),
            dict(front, name="front-stuck", front="async", stop=STOP, runs=1, host=False)]
    return out


LATE, STOP = 3, 3  # the rank whose submissions come late; a stuck rank submits this many

# ------------------------------------------------------------- the LM cases
TRAIN_ARCH, DECODE_ARCH = "qwen3-8b", "qwen2-1.5b"
TRAIN_CASES = [("tp", None, "none"), ("fsdp", None, "none"), ("tp", 0, "block"),
               ("fsdp", 0, "none")]  # mode, FSDP_MIN_ELEMENTS (0: every leaf FSDP), remat
MOE_CASES = {"ep": (8, True), "replicated": (7, False)}  # experts, shared expert
MOE_D, MOE_F, MOE_K, MOE_CF = 32, 64, 2, 16.0


def _lm_pair(arch, **kw):
    """(reference cfg, port cfg, reference params, port params) of a REDUCED LM."""
    from repro.configs.base import get_config as ref_config
    from repro.models import api as ref_models

    rcfg = dataclasses.replace(ref_config(arch, reduced=True), **kw)
    pcfg = dataclasses.replace(port_config(arch, reduced=True), **kw)
    rp = ref_models.model_init(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, rp)
    return rcfg, pcfg, rp, port_models.params_from_numpy(pcfg, tree, device="cpu")


def _lm_cases():
    """The LM cases the ranks run on their 2x2 mesh (and the parent runs
    through the unsharded port), with what the reference side needs."""
    from repro.data.pipeline import synthetic_batch
    from repro.models.lm.moe import moe_init as ref_moe_init

    out, ref = [], {}
    rcfg, pcfg, rp, pp = _lm_pair(TRAIN_ARCH, vocab_size=512)
    batch = synthetic_batch(seed=0, step=0, batch=8, seq=16, vocab=512)
    ref["train"] = (rcfg, rp, batch)
    for mode, fsdp_min, remat in TRAIN_CASES:
        out.append(dict(name=f"lm-train-{mode}-{fsdp_min}-{remat}", kind="lm-train", mode=mode,
                        fsdp_min=fsdp_min, cfg=dataclasses.replace(pcfg, remat=remat),
                        params=pp, batch=batch))
    rcfg, pcfg, rp, pp = _lm_pair(DECODE_ARCH)
    ref["decode"] = (rcfg, rp)
    prompt = np.random.default_rng(1).integers(0, pcfg.vocab_size, (8, 8)).astype(np.int64)
    for mode in ("tp", "fsdp"):
        out.append(dict(name=f"lm-decode-{mode}", kind="lm-decode", mode=mode, cfg=pcfg,
                        params=pp, batch=8, max_len=32, prompt=prompt))
    for mode, b in (("tp", 4), ("fsdp", 8)):
        out.append(dict(name=f"lm-engines-{mode}", kind="lm-engines", mode=mode, cfg=pcfg,
                        params=pp, max_len=16, new=4, prompt=prompt[:b]))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, MOE_D)).astype(np.float32)
    r = rng.standard_normal((4, 8, MOE_D)).astype(np.float32)
    for name, (e, shared) in MOE_CASES.items():
        rpm = ref_moe_init(jax.random.PRNGKey(2), MOE_D, MOE_F, e, "swiglu", shared_expert=shared,
                           dtype=jnp.float32)
        ppm = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), rpm)
        ref[f"moe-{name}"] = (rpm, x, e)
        out.append(dict(name=f"lm-moe-{name}", kind="lm-moe", params=ppm, e=e, k=MOE_K,
                        capacity_factor=MOE_CF, x=x, r=r))
    rng = np.random.default_rng(0)
    cmm = dict(x=rng.standard_normal((32, 64)).astype(np.float32),
               w=rng.standard_normal((64, 48)).astype(np.float32))
    ref["cmm"] = cmm
    out.append(dict(cmm, name="lm-cmm", kind="lm-cmm"))
    rng = np.random.default_rng(4)
    cp = {n: rng.standard_normal(shape).astype(np.float32) for n, shape in (
        ("q", (4, 16, 4, 16)), ("k", (4, 16, 2, 16)), ("v", (4, 16, 2, 16)),
        ("r", (4, 16, 4, 16)))}
    out.append(dict(cp, name="lm-cp", kind="lm-cp"))
    more, more_ref = _lm_zoo_cases()
    ref.update(more_ref)
    return out + more, ref


# the rest of the zoo under a policy: name -> (arch, overrides, mode, batch)
SSM_KW = dict(ssm_chunk=4)  # 3 chunks of 12 positions: the inter-chunk recurrence runs
SERVE_CASES = {
    "ssm-tp": ("mamba2-370m", SSM_KW, "tp", 4),
    "ssm-fsdp": ("mamba2-370m", SSM_KW, "fsdp", 4),
    "ssm-fsdp-seq": ("mamba2-370m", SSM_KW, "fsdp", 2),  # the sequence over "model"
    "hybrid-tp": ("jamba-v0.1-52b", dict(SSM_KW, capacity_factor=2.0), "tp", 4),
    "hybrid-fsdp": ("jamba-v0.1-52b", dict(SSM_KW, capacity_factor=2.0), "fsdp", 4),
    "int8-tp": ("qwen3-8b", dict(kv_cache_dtype="int8"), "tp", 4),
    "int8-fsdp": ("qwen3-8b", dict(kv_cache_dtype="int8"), "fsdp", 4),
    "vlm-tp": ("qwen2-vl-7b", {}, "tp", 4),
    "vlm-fsdp": ("qwen2-vl-7b", {}, "fsdp", 4),
    "encdec-tp": ("seamless-m4t-medium", {}, "tp", 4),
    "encdec-fsdp": ("seamless-m4t-medium", {}, "fsdp", 4),
}
SERVE_SEQ, SERVE_LEN, SERVE_STEPS, SRC_LEN = 12, 16, 4, 16
SSM_TRAIN = {"tp": 8, "fsdp": 8, "fsdp-seq": 2}  # mode -> batch (2: the sequence is split)
COMPRESS = {"topk": dict(compress="topk", ratio=0.05), "int8": dict(compress="int8", seed=3)}
CKPT = dict(steps=3, crash=2, batch=8, seq=16)


def _serve_batch(pcfg, b, rng):
    """(the prompt batch, the decode steps' batches) of a serve case."""
    s, d = SERVE_SEQ, pcfg.d_model
    if pcfg.encoder_layers > 0:
        tgt = rng.integers(0, pcfg.vocab_size, (b, SERVE_STEPS)).astype(np.int64)
        batch = {"src_embeds": rng.standard_normal((b, SRC_LEN, d)).astype(np.float32),
                 "tgt_tokens": tgt}
        return batch, [{"tokens": tgt[:, i:i + 1]} for i in range(SERVE_STEPS)]
    if pcfg.family == "vlm":  # distinct M-RoPE streams: a 2 x 4 image grid after 2 text tokens
        t = np.arange(s)
        pos = np.stack([t, t, t])
        pos[1, 2:10], pos[2, 2:10] = 2 + np.arange(8) // 4, 2 + np.arange(8) % 4
        pos[:, 10:] = np.arange(4, 6)
        batch = {"embeds": rng.standard_normal((b, s, d)).astype(np.float32),
                 "positions": np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int64).copy()}
        return batch, [{"embeds": rng.standard_normal((b, 1, d)).astype(np.float32)}
                       for _ in range(SERVE_STEPS)]
    batch = {"tokens": rng.integers(0, pcfg.vocab_size, (b, s)).astype(np.int64)}
    return batch, [{"tokens": rng.integers(0, pcfg.vocab_size, (b, 1)).astype(np.int64)}
                   for _ in range(SERVE_STEPS)]


def _lm_zoo_cases():
    """The mamba mixers, int8 KV, embeds, the enc-dec, compression and
    checkpoints under a policy (and what the reference side needs)."""
    from repro.data.pipeline import synthetic_batch

    out, ref, pairs = [], {}, {}
    for name, (arch, kw, mode, b) in SERVE_CASES.items():
        key = (arch, tuple(sorted(kw.items())))
        if key not in pairs:
            pairs[key] = _lm_pair(arch, **kw)
        rcfg, pcfg, rp, pp = pairs[key]
        batch, steps = _serve_batch(pcfg, b, np.random.default_rng(20 + b))  # tp, fsdp alike
        if mode == "fsdp" and b == 2:  # fsdp decode needs rows over both axes
            steps = []
        ref[f"serve-{name}"] = (rcfg, rp, batch, steps)
        out.append(dict(name=f"lm-serve-{name}", kind="lm-serve", mode=mode, cfg=pcfg,
                        params=pp, batch=batch, steps=steps, max_len=SERVE_LEN, fsdp=True))
    rcfg, pcfg, rp, pp = pairs[("mamba2-370m", tuple(sorted(SSM_KW.items())))]
    for mode, b in SSM_TRAIN.items():
        batch = synthetic_batch(seed=0, step=0, batch=b, seq=16, vocab=pcfg.vocab_size)
        ref[f"train-ssm-{mode}"] = (rcfg, rp, batch)
        out.append(dict(name=f"lm-train-ssm-{mode}", kind="lm-train", mode=mode.split("-")[0],
                        cfg=pcfg, params=pp, batch=batch))
    rcfg, pcfg, rp, pp = _lm_pair(DECODE_ARCH)
    batch = synthetic_batch(seed=0, step=0, batch=8, seq=16, vocab=pcfg.vocab_size)
    for name, kw in COMPRESS.items():
        ref[f"compress-{name}"] = (rcfg, rp, batch, kw)
        out.append(dict(kw, name=f"lm-compress-{name}", kind="lm-compress", mode="tp", cfg=pcfg,
                        params=pp, batch=batch))
    out.append(dict(CKPT, **COMPRESS["topk"], name="lm-ckpt", kind="lm-ckpt", mode="tp",
                    cfg=pcfg, runs=1))
    return out, ref


_REF_CMM = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.collective_matmul import allgather_matmul, reduce_scatter_matmul
x, w = (np.load(sys.argv[i]) for i in (1, 2))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
y1 = allgather_matmul(jax.device_put(x, NamedSharding(mesh, P("model", None))),
                      jax.device_put(w, NamedSharding(mesh, P(None, "model"))), mesh)
y2 = reduce_scatter_matmul(jax.device_put(x, NamedSharding(mesh, P(None, "model"))),
                           jax.device_put(w, NamedSharding(mesh, P("model", None))), mesh)
np.save(sys.argv[3], np.asarray(y1)); np.save(sys.argv[4], np.asarray(y2))
"""


def _start_reference_cmm(d, cmm):
    """The reference's collective matmuls on a faked 2x2 CPU mesh, in a
    subprocess that runs while the ranks do."""
    paths = [os.path.join(d, f"cmm_{n}.npy") for n in ("x", "w", "ag", "rs")]
    np.save(paths[0], cmm["x"])
    np.save(paths[1], cmm["w"])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_CMM, *paths], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, paths[2:]


def _front_requests():
    """Six small graphs of distinct sizes, two tenants (gold every third)."""
    out = []
    for i, n in enumerate((40, 46, 52, 58, 64, 70)):
        g = port_ds.make_dataset("citeseer", max_nodes=n, max_feature_dim=GNN_KW["d_model"],
                                 seed=10 + i)
        out.append(("gold" if i % 3 == 0 else "batch", g, g.features))
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(cases by name, each rank's outputs, the host loop's outputs)."""
    d = str(tmp_path_factory.mktemp("mesh"))
    models = _models()
    plan_dir = os.path.join(d, "plans")
    _, pcfg, _, pp, (_, pg) = models["gcn"]
    host_srv = GNNServeEngine(pcfg, pp, num_shards=cases.WORLD, partitioner="edges",
                              device="cpu")
    host_serve = host_srv.infer(pg, pg.features).outputs
    host_srv.save_plan_cache(plan_dir)
    case_list = _case_list(models, plan_dir)
    lm_list, lm_ref = _lm_cases()
    case_list += lm_list
    for c in case_list:
        if c["kind"] == "lm-ckpt":
            c["dir"] = os.path.join(d, "ckpt")
    torch.save({"cases": case_list, "timeout_s": 60}, os.path.join(d, "inputs.pt"))
    cmm_proc, cmm_paths = _start_reference_cmm(d, lm_ref["cmm"])
    try:
        started = cases.start_ranks(d)
        lm_ref["zoo"] = _zoo_reference(lm_ref)  # while the ranks run
        ranks = cases.wait_ranks(started, deadline_s=240.0)
        host = {c["name"]: cases.run_case(c, None) for c in case_list if c.get("host", True)}
        _, err = cmm_proc.communicate(timeout=300)
    finally:
        if cmm_proc.poll() is None:
            cmm_proc.kill()
    assert cmm_proc.returncode == 0, err[-3000:]
    lm_ref["cmm_out"] = [np.load(p) for p in cmm_paths]
    models["lm_ref"] = lm_ref
    return {c["name"]: c for c in case_list}, ranks, host, models, host_serve


def _rank_outputs(ranks, name):
    outs = [r[name]["y"] for r in ranks]
    for other in outs[1:]:  # every rank returns the same bits
        assert np.array_equal(outs[0], other)
    return outs[0]


# ------------------------------------------------------------- the outputs
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + ["gat"])
def test_mesh_forward_is_bitwise_the_host_loop(mesh_run, arch, kind, overlap):
    _, ranks, host, _, _ = mesh_run
    name = f"gnn-{arch}-{kind}-{overlap}"
    y = _rank_outputs(ranks, name)
    want = host[name]
    assert y.dtype == np.float32 and y.shape == want["y"].shape and np.isfinite(y).all()
    assert np.array_equal(y, want["y"])
    for r in ranks:  # one exchange an aggregate, every shard's halo rows counted
        assert r[name]["halo_bytes"] > 0 and r[name]["halo_ms"] == 0.0
        assert r[name]["split_exchanges"] == (r[name]["halo_exchanges"] if overlap else 0.0)
    assert ranks[0][name]["halo_bytes"] == ranks[3][name]["halo_bytes"]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_runtime_coefficient_is_bitwise_the_host_loop(mesh_run, kind, overlap):
    _, ranks, host, _, _ = mesh_run
    name = f"coeff-{kind}-{overlap}"
    assert np.array_equal(_rank_outputs(ranks, name), host[name]["y"])
    assert all(r[name]["halo_bytes"] > 0 and r[name]["halo_exchanges"] == 1.0 for r in ranks)
    # the reference's count: every shard's halo rows, f32, once
    c = mesh_run[0][name]
    splan = port_mp.compile_sharded_plans(c["graph"], c["engine_cfg"], partition=c["partition"],
                                          modes=("runtime",))
    assert ranks[0][name]["halo_bytes"] == splan.halo_total * 4 * c["x"].shape[1]


@pytest.mark.parametrize("arch,kind", [("gcn", "edges"), ("gat", "mincut")])
def test_port_host_loop_matches_the_reference(mesh_run, arch, kind):
    """The host loop the mesh is held to, against the reference's host loop
    on the same graph, partition and params (mixed tolerance): the static
    path under one partitioner, the runtime one under the other. The
    reference compiles ~15 s of XLA a case; ``tests/test_torch_sharded.py``
    holds every arch under both partitioners."""
    _, _, host, models, _ = mesh_run
    rcfg, _, rp, _, (rg, _) = models[arch]
    prepared = ref_api.prepare_graph(rcfg, rg)
    splan = ref_mp.compile_sharded_plans(
        prepared, ref_api.engine_config(rcfg),
        partition=ref_part.make_partition(prepared, cases.WORLD, kind),
        modes=(ref_api.agg_mode(rcfg),))
    want = np.asarray(ref_api.gnn_apply(rcfg, rp, ref_shard.ShardedAmpleEngine(prepared, splan),
                                        jnp.asarray(rg.features)))
    assert_mixed_close(host[f"gnn-{arch}-{kind}-False"]["y"], want)


def test_mesh_serving_warm_equals_cold_and_the_host_loop(mesh_run):
    _, ranks, _, _, host_serve = mesh_run
    for name in ("serve-gcn-False-False", "serve-gat-True-False"):
        for r in ranks:
            got = r[name]
            assert got["cache_hit"] == [False, True] and got["plan_ms"][1] == 0.0
            assert np.array_equal(got["y"][0], got["y"][1])
            assert got["num_shards"] == [4, 4] and got["halo_bytes"][0] > 0
        assert all(np.array_equal(r[name]["y"][0], ranks[0][name]["y"][0]) for r in ranks)
    assert np.array_equal(ranks[0]["serve-gcn-False-False"]["y"][0], host_serve)


def test_mesh_serving_loads_a_host_loop_plan_cache_as_a_hit(mesh_run):
    """A plan cache saved by a host-loop engine (edges, unsplit) loads into a
    mesh engine with the overlapped exchange: its first request is a hit,
    plans nothing, and is bitwise the host loop's output."""
    _, ranks, _, _, host_serve = mesh_run
    for r in ranks:
        got = r["serve-gcn-True-True"]
        assert got["loaded"] == 1 and got["planner_calls"] == 0
        assert got["cache_hit"] == [True, True] and got["plan_ms"] == [0.0, 0.0]
        assert all(np.array_equal(y, host_serve) for y in got["y"])


# ------------------------------------------------------------- training
def _same_grads(ranks, name, want):
    """Every rank's output and gradients bitwise ``want``'s (None where
    an input got none)."""
    for r in ranks:
        got = r[name]
        assert np.array_equal(got["y"], want["y"])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype and np.isfinite(g).all() and np.array_equal(g, w)
    assert any(w is not None and np.abs(w).max() > 0 for w in want["grads"])


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + ["gat"])
def test_mesh_training_is_bitwise_the_host_loop(mesh_run, arch, kind, overlap):
    """The arch's loss under grad on a mesh: the input's and every
    parameter's gradient bitwise the host loop's on every rank (a mixed
    engine: the int8 group's scale gradient rides in the input's)."""
    _, ranks, host, _, _ = mesh_run
    _same_grads(ranks, f"train-{arch}-{kind}-{overlap}", host[f"train-{arch}-{kind}-False"])


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_runtime_coefficient_gradient_is_bitwise_the_host_loop(mesh_run, kind):
    """A raw f32[E] runtime coefficient that requires grad: its gradient
    (each shard's edges all-gathered into global edge order) and the
    rows'."""
    _, ranks, host, _, _ = mesh_run
    _same_grads(ranks, f"train-coeff-{kind}", host[f"train-coeff-{kind}"])


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_int8_scale_gradient_is_bitwise_the_host_loop(mesh_run, kind):
    """The int8 group's scale as a leaf: the shards' contributions
    all-gathered and summed in shard order, as the host loop sums them."""
    _, ranks, host, _, _ = mesh_run
    name = f"train-scale-{kind}"
    _same_grads(ranks, name, host[name])
    assert host[name]["grads"][1].shape == () and host[name]["grads"][1] != 0


# ------------------------------------------------------------- the fronts
def _same_runs(ranks, name, want):
    for r in ranks:
        for got, w in zip(r[name]["runs"], want["runs"]):
            assert got["windows"] == w["windows"] and got["window_log"] == w["window_log"]
            assert all(got["done"]) and len(got["results"]) == len(w["results"])
            for a, b in zip(got["results"], w["results"]):
                assert isinstance(a, np.ndarray) and np.array_equal(a, b)


@pytest.mark.parametrize("front", ["async", "router"])
def test_mesh_fronts_run_rank_0s_windows_bitwise_the_host_loop(mesh_run, front):
    """Rank 3's submissions arrive late, from a thread: every rank runs rank
    0's windows, bitwise the same front over the host loop (async is sync:
    the host loop's infer_batch of each window); a second drain of the stream
    (warm) is bitwise the first (cold)."""
    _, ranks, host, _, _ = mesh_run
    name = f"front-{front}"
    _same_runs(ranks, name, host[name])
    for r in ranks:
        cold, warm = r[name]["runs"]
        assert all(np.array_equal(a, b) for a, b in zip(cold["results"], warm["results"]))
    assert all(r[name]["stats"] == ranks[0][name]["stats"] for r in ranks[1:]
               if front == "router")


def test_mesh_router_keeps_each_tenants_order(mesh_run):
    _, ranks, _, _, _ = mesh_run
    log = ranks[0]["front-router"]["runs"][0]["window_log"]
    assert sum(len(w) for w in log) == 6 and log[0][0] == ("gold", 0)
    for tenant in ("gold", "batch"):
        seqs = [seq for w in log for t, seq in w if t == tenant]
        assert seqs == sorted(seqs)


def test_a_stuck_follower_fails_its_windows_on_every_rank(mesh_run):
    """Rank 3 submits only the first 3 requests before it drains: the
    windows holding the others fail on every rank after the follower's wait
    (a timeout there, another rank's failure elsewhere); the windows before
    them run. The missing requests, submitted after the drain, complete at
    once with the window's error."""
    _, ranks, _, _, _ = mesh_run
    for r in ranks:
        run = r["front-stuck"]["runs"][0]
        failed = "TimeoutError" if r["_rank"] == LATE else "RuntimeError"
        assert run["windows"] == [[40, 46]] and all(run["done"])
        assert all(isinstance(x, np.ndarray) for x in run["results"][:2])
        assert run["results"][2:] == [failed] * 4
        assert r["front-stuck"]["stats"]["window_failures"] == 2


def test_ranks_are_one_per_shard_over_gloo_and_import_only_the_port(mesh_run):
    _, ranks, _, _, _ = mesh_run
    assert [r["_rank"] for r in ranks] == list(range(cases.WORLD))
    assert all(r["_backend"] == "gloo" and r["_foreign"] == [] for r in ranks)


# ------------------------------------------------------------ no hang
@pytest.mark.parametrize("fault", ["die", "hang", "die-backward", "hang-window"])
def test_a_dead_or_stuck_rank_fails_within_the_deadline(tmp_path, fault):
    """Rank 2 exits, or sleeps past every collective, before a request,
    between a training step's forward and backward ("die-backward": the
    others wait in the backward's all-gathers), or before it follows rank
    0's window ("hang-window": the others wait in the window's broadcast).
    ``run_ranks`` kills them all and raises."""
    pcfg, pp = (cfg_pair("gcn", **GNN_KW)[1],
                params_pair(*cfg_pair("gcn", **GNN_KW), seed=0)[1])
    _, pg = _graphs(60, 1, 20)
    prepared = port_api.prepare_graph(pcfg, pg)
    base = dict(graph=prepared, engine_cfg=port_api.engine_config(pcfg),
                partition=port_part.make_partition(prepared, cases.WORLD, "edges"), x=pg.features)
    case = {
        "die-backward": dict(base, name="train", kind="train", cfg=pcfg, params=pp,
                             r=np.ones((prepared.num_nodes, pcfg.gnn_layer_dims[-1]), np.float32)),
        "hang-window": dict(name="front", kind="front", cfg=pcfg, params=pp, front="async",
                            requests=[("gold", pg, pg.features)] * 2, window=2, runs=1),
    }.get(fault, dict(base, name="gnn", kind="coeff", coeff=np.ones(prepared.num_edges, np.float32)))
    torch.save({"cases": [case], "timeout_s": 2, "fault": {2: fault}},
               os.path.join(tmp_path, "inputs.pt"))
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        cases.run_ranks(str(tmp_path), deadline_s=20.0)
    assert time.monotonic() - t0 < 30.0


# ------------------------------------------------------------ the state
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_state_places_every_halo_and_owned_row(kind):
    _, pg = _graphs(180, 4, 20)
    part = port_part.make_partition(pg, cases.WORLD, kind)
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          partition=part, modes=("sum",))
    ms = build_mesh_state(splan)
    assert ms.p_max == max(sp.num_owned for sp in splan.shards)
    assert ms.h_max == max(sp.halo_size for sp in splan.shards)
    stacked = ms.pad_gather.reshape(-1)  # the global row of each stacked row
    for k, sp in enumerate(splan.shards):
        assert np.array_equal(ms.pad_gather[k, : sp.num_owned], sp.shard.owned)
        assert np.array_equal(stacked[ms.halo_rows(k, sp.halo_size)], sp.shard.halo)
    assert np.array_equal(stacked[ms.out_idx], np.arange(pg.num_nodes))


# ------------------------------------------------------------ refusals
class _Mesh:
    """What the engine reads of a ``DeviceMesh`` before any collective."""

    def __init__(self, names=("shard",), size=4, device_type="cpu"):
        self.mesh_dim_names, self._size, self.device_type = names, size, device_type

    def size(self):
        return self._size


@pytest.fixture(scope="module")
def gcn_small():
    _, pcfg = cfg_pair("gcn", **GNN_KW)
    _, pg = _graphs(120, 2, 20)
    splan = port_mp.compile_sharded_plans(pg, port_mp.EngineConfig(edges_per_tile=64),
                                          num_shards=4, modes=("sum", "runtime"))
    return pcfg, pg, splan


@pytest.mark.parametrize("make", [
    lambda pcfg, pg, splan: ShardedAmpleEngine(pg, splan, mesh=_Mesh(names=("x",))),
    lambda pcfg, pg, splan: port_api.make_engine(pcfg, pg, num_shards=4, mesh=_Mesh(names=None)),
], ids=["engine", "make_engine"])
def test_mesh_needs_one_shard_dimension(gcn_small, make):
    with pytest.raises(ValueError, match=r"mesh axes must be \('shard',\)"):
        make(*gcn_small)


def test_mesh_needs_one_rank_per_shard(gcn_small):
    pcfg, pg, splan = gcn_small
    with pytest.raises(ValueError, match="mesh has 2 devices but the plan has 4 shards"):
        ShardedAmpleEngine(pg, splan, mesh=_Mesh(size=2))
    with pytest.raises(ValueError, match="num_shards=4; pass --num-shards 3"):
        GNNServeEngine(pcfg, num_shards=4, mesh=_Mesh(size=3), device="cpu")


def test_mesh_refuses_rows_on_another_device(gcn_small):
    _, pg, splan = gcn_small
    eng = ShardedAmpleEngine(pg, splan, mesh=_Mesh(device_type="cuda"))
    with torch.no_grad(), pytest.raises(ValueError, match="mesh holds 'cuda' devices"):
        eng.aggregate(torch.randn(pg.num_nodes, 3), mode="sum")




# ------------------------------------------------------- the LM on a mesh
def _lm_runs(ranks, name, per_rank=()):
    """Each rank's runs of an LM case (two, or the case's ``runs``), after
    checking that each is bitwise the first and that every rank returned
    the same bits (but for the ``per_rank`` keys)."""
    first = ranks[0][name]["runs"][0]
    for r in ranks:
        a, *rest = r[name]["runs"]
        for b in rest:
            _same_bits(a, b, name)
        _same_bits({k: v for k, v in a.items() if k not in per_rank},
                   {k: v for k, v in first.items() if k not in per_rank}, name)
    return first


def _same_bits(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= tol, err


@pytest.fixture(scope="module")
def lm_reference_step(mesh_run):
    """The reference's single-device train step (jitted, as
    ``tests/test_distributed.py:45-86`` runs it)."""
    from repro.train.train_step import init_train_state, make_train_step

    rcfg, rp, batch = mesh_run[3]["lm_ref"]["train"]
    state = init_train_state(rcfg, rp)
    s1, m1 = jax.jit(make_train_step(rcfg))(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m1["loss"]), [np.asarray(a, np.float32)
                               for a in jax.tree_util.tree_leaves(s1["params"])]


@pytest.mark.parametrize("mode,fsdp_min,remat", TRAIN_CASES)
def test_mesh_lm_train_step_matches_the_reference_and_the_unsharded_port(
        mesh_run, lm_reference_step, mode, fsdp_min, remat):
    """One ``make_train_step(cfg, policy=)`` step of REDUCED qwen3-8b on the
    (2, 2) mesh (gathered back with ``gather_tree``): within the reference's
    bounds of its single-device step (loss 5e-3, params 5e-2,
    ``tests/test_distributed.py:86-91``) and within 1e-5 of the unsharded
    port's step; the same bits on every rank and in a second run. FSDP on
    every leaf (``FSDP_MIN_ELEMENTS`` 0) and ``remat="block"`` run the
    gathers and the recompute."""
    _, ranks, host, _, _ = mesh_run
    name = f"lm-train-{mode}-{fsdp_min}-{remat}"
    got = _lm_runs(ranks, name)
    want = host[name]["runs"][0]
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * max(1.0, want["grad_norm"])
    for g, w in zip(got["params"], want["params"]):
        _close(g, w, 1e-5)
    ref_loss, ref_params = lm_reference_step
    assert abs(got["loss"] - ref_loss) < 5e-3
    assert max(float(np.abs(g - w).max()) for g, w in zip(got["params"], ref_params)) < 5e-2


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_mesh_lm_decode_over_a_sharded_cache(mesh_run, mode):
    """REDUCED qwen2-1.5b (3 heads, 1 KV head: the heads stay whole over the
    2-way model axis) decoding over a cache whose positions are split over
    "model": the first step from an empty cache within 5e-3 of the
    reference's single-device ``model_decode_step``
    (``tests/test_distributed.py:99-119``); that step and a prefill's two
    greedy steps within 1e-5 of the unsharded port; the same bits on every
    rank and in a second run."""
    from repro.models import api as ref_models

    _, ranks, host, models, _ = mesh_run
    name = f"lm-decode-{mode}"
    got = _lm_runs(ranks, name)
    want = host[name]["runs"][0]
    _close(got["at0"], want["at0"], 1e-5)
    for g, w in zip(got["steps"], want["steps"]):
        _close(g, w, 1e-5)
    assert ranks[0][name]["runs"][0]["cache_shape"][2] == 16  # 32 positions over 2 ranks
    rcfg, rp = models["lm_ref"]["decode"]
    batch = {"tokens": jnp.ones((8, 1), jnp.int32)}
    cache = ref_models.model_init_cache(rcfg, rp, batch, max_len=32)
    lg, _ = ref_models.model_decode_step(rp, rcfg, batch, cache, jnp.int32(0))
    _close(got["at0"], np.asarray(lg), 5e-3)


@pytest.mark.parametrize("variant", list(MOE_CASES))
def test_mesh_moe_apply_sharded_matches_the_plain_layer(mesh_run, variant):
    """``moe_apply_sharded`` (EP: 8 experts with a shared one, 4 a model
    rank; replicated experts: 7 on the 2-way axis, tokens split over both
    axes) at capacity 16 (no drops): within 1e-5 of the reference's plain
    ``moe_apply``, its output and every gradient within 1e-5 of the
    unsharded port's; the same bits on every rank and in a second run."""
    from repro.models.lm.moe import moe_apply as ref_moe_apply

    _, ranks, host, models, _ = mesh_run
    name = f"lm-moe-{variant}"
    got = _lm_runs(ranks, name)
    want = host[name]["runs"][0]
    _close(got["out"], want["out"], 1e-5)
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        _close(g, w, 1e-5)
    rpm, x, e = models["lm_ref"][f"moe-{variant}"]
    ref, _ = ref_moe_apply(rpm, jnp.asarray(x), num_experts=e, top_k=MOE_K, kind="swiglu",
                           capacity_factor=MOE_CF)
    _close(got["out"], np.asarray(ref), 1e-5)


def test_mesh_collective_matmuls_match_the_reference(mesh_run):
    """``allgather_matmul`` and ``reduce_scatter_matmul`` on the model axis
    (rings of ``batch_isend_irecv``) against the reference's own results for
    the same inputs on a faked 2x2 mesh (1e-4, ``tests/test_distributed.py:33-52``)."""
    _, ranks, _, models, _ = mesh_run
    got = _lm_runs(ranks, "lm-cmm")
    ag, rs = models["lm_ref"]["cmm_out"]
    _close(got["ag"], ag, 1e-4)
    _close(got["rs"], rs, 1e-4)
    assert got["ag_local"] == (32, 24) and got["rs_local"] == (16, 48)


def test_mesh_context_parallel_attention_cuts_kv_to_the_rows_it_serves(mesh_run):
    """The ``qkv`` hook on head-sharded q/k/v (B 4, S 16, H 4, KV 2): q moves
    to this rank's 8 rows of every head, K/V are gathered and cut to the
    first 8 or 16 positions, contiguous (no copy for the kernel); the causal
    rows and the q/k/v gradients within 1e-6 of the unsharded plain
    attention (the plain version reduces over the cut length, so the rows
    are not bitwise at every shape)."""
    _, ranks, host, _, _ = mesh_run
    got = _lm_runs(ranks, "lm-cp", per_rank=("kv_shape",))
    want = host["lm-cp"]["runs"][0]
    _close(got["out"], want["out"], 1e-6)
    for g, w in zip(got["grads"], want["grads"]):
        _close(g, w, 1e-6)
    for r in ranks:
        run = r["lm-cp"]["runs"][0]
        c = r["_rank"] % 2  # the model coordinate
        assert run["q_shape"] == (2, 8, 4, 16)
        assert run["kv_shape"] == (2, 8 * (c + 1), 2, 16) and run["kv_contiguous"]


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_mesh_serve_engine_and_trainer_take_the_policy(mesh_run, mode):
    """``ServeEngine(..., policy=)`` and ``Trainer(..., policy=)`` on the (2, 2)
    mesh (REDUCED qwen2-1.5b): every rank returns the whole batch's greedy
    tokens, equal to the unsharded engine's; two Trainer steps (the
    synthetic batches of seed 0, each rank cutting the same seeded params)
    within 1e-5 of the unsharded Trainer's loss and params."""
    _, ranks, host, _, _ = mesh_run
    name = f"lm-engines-{mode}"
    got = _lm_runs(ranks, name)
    want = host[name]["runs"][0]
    assert np.array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].shape == (want["tokens"].shape[0], 8 + 4)
    assert max(abs(a - b) for a, b in zip(got["loss"], want["loss"])) <= 1e-5
    for g, w in zip(got["params"], want["params"]):
        _close(g, w, 1e-5)


# ------------------------------------------- the rest of the zoo on a mesh
LM_ATOL, LM_RTOL = 5e-4, 1e-3  # f32 LM paths, tests/test_torch_lm.py:12-13


def _ref_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LM_ATOL, rtol=LM_RTOL)


def _ref_serve(rcfg, rp, batch, steps):
    """The reference's single-device forward, prefill and decode steps of a
    serve case (the enc-dec decodes from ``model_init_cache``)."""
    from repro.models import api as ref_models

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"forward": np.asarray(ref_models.model_forward(rp, rcfg, jb)[0])}
    lg, cache, n = ref_models.model_prefill(rp, rcfg, jb, SERVE_LEN)
    out["prefill"] = np.asarray(lg)
    out["prefill_cache"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(cache)]
    if "src_embeds" in batch:
        cache, n = ref_models.model_init_cache(rcfg, rp, jb, SERVE_LEN), 0
    out["steps"] = []
    for i, step in enumerate(steps):
        lg, cache = ref_models.model_decode_step(
            rp, rcfg, {k: jnp.asarray(v) for k, v in step.items()}, cache,
            jnp.asarray(int(n) + i, jnp.int32))
        out["steps"].append(np.asarray(lg))
    out["decode_cache"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(cache)]
    return out


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_mesh_lm_serves_the_rest_of_the_zoo(mesh_run, name):
    """``model_forward``, ``model_prefill`` and ``SERVE_STEPS`` decode steps
    under the policy (FSDP on every large leaf) of the mamba mixers (the SSD
    at the rank's H/tp heads in tp; fsdp rows over both axes, or the
    sequence over "model" with B 2), the hybrid's (mamba, attention and the
    sharded MoE in one unit), an int8 KV cache, an embeds input with
    distinct M-RoPE streams and the enc-dec (encoder, cross-attention, the
    cross caches cut over the encoder's positions; decode from
    ``model_init_cache``): logits, every prefill and decode cache leaf
    gathered by ``cache_shardings`` within 1e-5 of the unsharded port and
    within the LM tolerances of the reference's single device; the same
    bits on every rank and in a second run; every rank's cache at its local
    shape."""
    _, ranks, host, models, _ = mesh_run
    got = _lm_runs(ranks, f"lm-serve-{name}", per_rank=("cache_shapes",))
    want = host[f"lm-serve-{name}"]["runs"][0]
    ref = models["lm_ref"]["zoo"][f"serve-{name}"]
    steps = models["lm_ref"][f"serve-{name}"][3]
    assert len(got["steps"]) == len(steps)
    for key in ("forward", "prefill", "steps", "prefill_cache") + (
            ("decode_cache",) if steps else ()):
        assert len(got[key]) == len(want[key]) == len(ref[key]), key
        for g, w, r in zip(got[key], want[key], ref[key]):
            _close(g, w, 1e-5)
            _ref_close(g, r)
    assert abs(got["aux"] - want["aux"]) <= 1e-5
    whole = [w.shape for w in want["prefill_cache"]]
    for r in ranks:  # heads, channels, positions over "model"; rows over "data"
        for loc, full in zip(r[f"lm-serve-{name}"]["runs"][0]["cache_shapes"], whole):
            assert len(loc) == len(full) and loc[0] == full[0]
            assert loc[1] == full[1] // 2 and all(f in (l_, 2 * l_) for l_, f in zip(loc, full))


def _zoo_reference(lm_ref):
    """The reference's single-device side of the zoo cases: each serve
    input's forward, prefill and decode (once for tp and fsdp alike), the
    mamba train steps and the top-k compressed step (jitted, as
    ``tests/test_distributed.py:45-86``)."""
    from repro.distributed.compression import TopKCompressor as RefTopK
    from repro.train.train_step import init_train_state, make_train_step

    out, seen = {}, {}
    for key, entry in lm_ref.items():
        if key.startswith("serve-"):
            rcfg, rp, batch, steps = entry
            inputs = (rcfg.name, rcfg.kv_cache_dtype, len(next(iter(batch.values()))), len(steps))
            if inputs not in seen:
                seen[inputs] = _ref_serve(rcfg, rp, batch, steps)
            out[key] = seen[inputs]
        elif key.startswith("train-ssm") or key == "compress-topk":
            rcfg, rp, batch = entry[:3]
            comp = RefTopK(ratio=entry[3]["ratio"]) if key == "compress-topk" else None
            state = init_train_state(rcfg, rp)
            if comp is not None:
                state["compress"] = comp.init_state(rp)
            s1, m1 = jax.jit(make_train_step(rcfg, compressor=comp))(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
            out[key] = (float(m1["loss"]), [np.asarray(a, np.float32)
                                            for a in jax.tree_util.tree_leaves(s1["params"])])
    return out


@pytest.fixture(scope="module")
def lm_zoo_reference_steps(mesh_run):
    return mesh_run[3]["lm_ref"]["zoo"]


@pytest.mark.parametrize("mode", list(SSM_TRAIN))
def test_mesh_mamba_train_step_matches_the_reference_and_the_unsharded_port(
        mesh_run, lm_zoo_reference_steps, mode):
    """One ``make_train_step(cfg, policy=)`` step of REDUCED mamba2-370m: tp
    runs the SSD forward and backward at the rank's head shard (B and C
    whole on every rank, their gradient summed over "model"; the gated
    norm's squares summed over "model"); fsdp on rows over both axes, or (B
    2) on the sequence gathered over "model". Within 1e-5 of the unsharded
    port's step, within the reference's bounds of its single-device step
    (loss 5e-3, params 5e-2); the same bits on every rank and in a second
    run."""
    _, ranks, host, _, _ = mesh_run
    name = f"lm-train-ssm-{mode}"
    got = _lm_runs(ranks, name)
    want = host[name]["runs"][0]
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * max(1.0, want["grad_norm"])
    for g, w in zip(got["params"], want["params"]):
        _close(g, w, 1e-5)
    ref_loss, ref_params = lm_zoo_reference_steps[f"train-ssm-{mode}"]
    assert abs(got["loss"] - ref_loss) < 5e-3
    assert max(float(np.abs(g - w).max()) for g, w in zip(got["params"], ref_params)) < 5e-2


def _bitwise_trees(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("kind", list(COMPRESS))
def test_mesh_compressed_step_is_bitwise_the_unsharded_compressor(mesh_run, kind):
    """A REDUCED qwen2-1.5b tp step with each compressor: given the mesh's
    gradients (gathered), the unsharded port's compressor sends bitwise what
    the shards sent and keeps bitwise their error state (top-k's threshold
    from the union of every shard's top k, int8's scale from a max
    all-reduce and its draws cut from the whole leaf's), and AdamW on what
    was sent, at the step's norm and lr, gives bitwise the mesh's new
    params; the same bits on every rank and in a second run."""
    from repro_torch.distributed.compression import Int8Compressor, TopKCompressor
    from repro_torch.optim.adamw import AdamWConfig, _rebuild, adamw_init, adamw_update

    _, ranks, host, _, _ = mesh_run
    name = f"lm-compress-{kind}"
    got = _lm_runs(ranks, name)
    case = mesh_run[0][name]
    comp = (TopKCompressor(ratio=case["ratio"]) if kind == "topk"
            else Int8Compressor(seed=case["seed"]))
    like = case["params"]

    def tree(leaves):
        return _rebuild(like, iter(torch.from_numpy(a) for a in leaves))

    sent, err = comp.compress_decompress(tree(got["grads"]), tree(got["err"]))
    _bitwise_trees([t.numpy() for t in cases._leaves(sent)], got["sent"])
    _bitwise_trees([t.numpy() for t in cases._leaves(err)], got["new_err"])
    _bitwise_trees(got["new_err"], got["state_err"])
    params = tree([t.numpy() for t in cases._leaves(like)])
    new, _, _ = adamw_update(sent, adamw_init(params), params, AdamWConfig(),
                             lr=torch.tensor(got["lr"], dtype=torch.float32),
                             gnorm=torch.tensor(got["grad_norm"], dtype=torch.float32))
    _bitwise_trees([t.detach().numpy() for t in cases._leaves(new)], got["params"])
    want = host[name]["runs"][0]  # the unsharded port's own compressed step
    assert abs(got["loss"] - want["loss"]) <= 1e-5


@pytest.mark.parametrize("kind", list(COMPRESS))
def test_mesh_clip_norm_is_the_compressed_gradients_norm(mesh_run, kind):
    """Under a policy with a compressor AdamW clips by the norm of what the
    compressor sent (the reference's ``adamw_update`` takes the norm of the
    compressed gradients), not of the gradients before it: the step's
    grad_norm is the sent tree's norm and differs from the raw one's."""
    from repro_torch.optim.adamw import global_norm

    _, ranks, _, _, _ = mesh_run
    got = _lm_runs(ranks, f"lm-compress-{kind}")
    sent = float(global_norm([torch.from_numpy(a) for a in got["sent"]]))
    raw = float(global_norm([torch.from_numpy(a) for a in got["grads"]]))
    assert abs(got["grad_norm"] - sent) <= 1e-6 * sent
    assert abs(raw - sent) > 1e-4 * raw


def test_mesh_topk_step_matches_the_reference_compressed_step(mesh_run, lm_zoo_reference_steps):
    """The mesh's top-k compressed step within the train-step bounds (loss
    5e-3, params 5e-2) of the reference's single-device compressed step."""
    _, ranks, _, _, _ = mesh_run
    got = _lm_runs(ranks, "lm-compress-topk")
    ref_loss, ref_params = lm_zoo_reference_steps["compress-topk"]
    assert abs(got["loss"] - ref_loss) < 5e-3
    assert max(float(np.abs(g - w).max()) for g, w in zip(got["params"], ref_params)) < 5e-2


def test_mesh_checkpoint_resume_is_bitwise_a_straight_run(mesh_run):
    """``Trainer(ckpt_dir=, policy=)`` (top-k error feedback in the state,
    async saves gathered at the call and written by rank 0) crashed after
    step 2 and resumed: bitwise the uninterrupted mesh run on every rank."""
    _, ranks, _, _, _ = mesh_run
    got = _lm_runs(ranks, "lm-ckpt")
    _bitwise_trees(got["resumed"], got["straight"])
    assert got["files"] == [f"step_{s:09d}" for s in range(1, CKPT["steps"] + 1)]


def test_mesh_and_unsharded_checkpoints_restore_into_each_other(mesh_run):
    """The mesh's step-2 checkpoint resumed by an unsharded Trainer, and an
    unsharded run's step-2 checkpoint resumed under the policy: each within
    1e-5 of the other side's uninterrupted run."""
    _, ranks, host, _, _ = mesh_run
    got = _lm_runs(ranks, "lm-ckpt")
    want = host["lm-ckpt"]["runs"][0]["straight"]
    for g, w in zip(got["mesh_to_plain"], got["straight"]):
        _close(g, w, 1e-5)
    for g, w in zip(got["plain_to_mesh"], want):
        _close(g, w, 1e-5)
    for g, w in zip(got["straight"], want):
        _close(g, w, 1e-5)
