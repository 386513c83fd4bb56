"""The port's sharding rules, mesh helpers, elastic plans and MoE dispatch
groups against the reference, on the CPU.

The reference's rules need a mesh of devices, so one subprocess with 8 faked
CPU devices (as ``tests/test_distributed.py:18-30`` runs them) reads its
``param_shardings`` (fsdp on and off, ``tp`` and ``fsdp`` modes),
``state_shardings``, ``batch_shardings`` and ``cache_shardings`` for every
dense and MoE config (REDUCED params and FULL shapes) on (2, 4) and (2, 2)
meshes. The port's placements, on a stand-in mesh (the rules read only the
axis names and sizes), must equal each ``PartitionSpec`` read per mesh axis:
``Shard(d)`` where tensor dim d names the axis, ``Replicate()`` elsewhere.
``shard_tree`` cuts every leaf into blocks that put it back bitwise.
``elastic.py`` is standard library in both packages and is compared over a
sweep. The port's ``moe_apply`` under a stub policy (dispatch groups 2 and
4, identity ``ebuf``, no mesh) is held within 1e-5 of the reference's, which
takes its grouped path on one device, with equal expert loads. A policy's
``init_cache`` makes each rank's block of the whole cache.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.distributed import elastic as ref_elastic
from repro.models.lm.moe import moe_apply as ref_moe_apply
from repro.models.lm.moe import moe_init as ref_moe_init
from repro_torch.configs.base import get_config
from repro_torch.distributed import elastic as port_elastic
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import api
from repro_torch.models.lm.moe import moe_apply
from repro_torch.models.lm.transformer import init_cache
from repro_torch.optim.adamw import AdamWState
from repro_torch.serve.engine import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-8b", "qwen2-1.5b", "smollm-360m", "nemotron-4-15b", "granite-moe-3b-a800m",
         "llama4-maverick-400b-a17b", "mamba2-370m", "jamba-v0.1-52b", "qwen2-vl-7b",
         "seamless-m4t-medium"]
MESHES = {"2x4": (2, 4), "2x2": (2, 2)}
BATCHES = (8, 6, 4, 2, 1)
CACHES = ((8, 32), (3, 30))

_REFERENCE = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.distributed.sharding import (batch_shardings, cache_shardings, param_shardings,
                                        state_shardings)
from repro.models.api import model_init
from repro.models.lm.transformer import init_cache
from repro.train.train_step import init_train_state

ARCHS, MESHES, BATCHES, CACHES = json.loads(sys.argv[1])
devs = np.array(jax.devices())


def key(p):
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def flat(tree, mesh):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(s.spec) + (None,) * 8
        dims = []
        for a in mesh.axis_names:
            d = [i for i, e in enumerate(spec) if e == a or (isinstance(e, tuple) and a in e)]
            dims.append(d[0] if d else None)
        out["/".join(key(p) for p in path)] = dims
    return out


out = {}
for arch in ARCHS:
    for reduced in (True, False):
        cfg = get_config(arch, reduced=reduced)
        init = lambda: model_init(cfg, jax.random.PRNGKey(0))
        params = init() if reduced else jax.eval_shape(init)
        for mname, shape in MESHES.items():
            n = shape[0] * shape[1]
            mesh = Mesh(devs[:n].reshape(shape), ("data", "model"))
            for mode in ("tp", "fsdp"):
                for fsdp in (True, False):
                    out[f"params/{arch}/{reduced}/{mname}/{mode}/{fsdp}"] = flat(
                        param_shardings(cfg, params, mesh, fsdp=fsdp, mode=mode), mesh)
                if not reduced:
                    continue
                state = jax.eval_shape(lambda: init_train_state(cfg, init()))
                out[f"state/{arch}/{mname}/{mode}"] = flat(
                    state_shardings(cfg, state, mesh, mode=mode), mesh)
                for b in BATCHES:
                    bs = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                          "labels": jax.ShapeDtypeStruct((b, 16), np.int32)}
                    out[f"batch/{arch}/{mname}/{mode}/{b}"] = flat(
                        batch_shardings(cfg, bs, mesh, mode=mode), mesh)
            if reduced:
                for b, l in CACHES:
                    cache = jax.eval_shape(lambda: init_cache(cfg, b, l))
                    out[f"cache/{arch}/{mname}/{b}/{l}"] = flat(
                        cache_shardings(cfg, cache, mesh, batch=b), mesh)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's specs, each as one tensor dim (or None) per mesh axis."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    env.pop("REPRO_DEBUG_MESH", None)
    args = json.dumps([ARCHS, MESHES, BATCHES, CACHES])
    out = subprocess.run([sys.executable, "-c", _REFERENCE, args], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


class StandIn:
    """What the rules and a policy read of a ``DeviceMesh``: its axis names,
    sizes and (for ``shard_tree``) this rank's coordinate."""

    def __init__(self, shape, names=("data", "model"), coordinate=None):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coord = coordinate or (0,) * len(shape)

    def size(self, dim=None):
        return int(np.prod(self.shape)) if dim is None else self.shape[dim]

    def get_local_rank(self, name):
        return self._coord[self.mesh_dim_names.index(name)]


def _flat(tree, path=""):
    """{path: placements} with the reference's paths (sorted dict keys, list
    indices, NamedTuple field names)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, AdamWState):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: [p.dim if isinstance(p, Shard) else None for p in tree]}


def _same(port_tree, want):
    got = _flat(port_tree)
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, bad


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_equal_the_reference_specs(reference, arch, reduced, mname):
    cfg = get_config(arch, reduced=reduced)
    mesh = StandIn(MESHES[mname])
    shapes = api.param_shapes(cfg)
    for mode, fsdp in itertools.product(("tp", "fsdp"), (True, False)):
        _same(sh.param_shardings(cfg, shapes, mesh, fsdp=fsdp, mode=mode),
              reference[f"params/{arch}/{reduced}/{mname}/{mode}/{fsdp}"])


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_batch_and_cache_placements_equal_the_reference_specs(reference, arch, mname):
    cfg = get_config(arch, reduced=True)
    mesh = StandIn(MESHES[mname])
    shapes = api.param_shapes(cfg)
    state = {"params": shapes, "opt": AdamWState(step=(), m=shapes, v=shapes), "step": ()}
    for mode in ("tp", "fsdp"):
        _same(sh.state_shardings(cfg, state, mesh, mode=mode),
              reference[f"state/{arch}/{mname}/{mode}"])
        for b in BATCHES:
            _same(sh.batch_shardings(cfg, {"tokens": (b, 16), "labels": (b, 16)}, mesh,
                                     mode=mode), reference[f"batch/{arch}/{mname}/{mode}/{b}"])
    for b, length in CACHES:
        cache = init_cache(cfg, b, length, device="meta")
        _same(sh.cache_shardings(cfg, cache, mesh, batch=b),
              reference[f"cache/{arch}/{mname}/{b}/{length}"])


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m"])
def test_shard_tree_blocks_put_every_leaf_back_bitwise(arch, mode, monkeypatch):
    """Every rank's blocks (FSDP on every leaf, so both axes cut), put back
    in mesh order, give each leaf bitwise."""
    monkeypatch.setattr(sh, "FSDP_MIN_ELEMENTS", 0)
    cfg = get_config(arch, reduced=True)
    params = api.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = StandIn((2, 2))
    pl = sh.param_shardings(cfg, params, mesh, mode=mode)
    blocks = {c: sh.shard_tree(params, pl, mesh, coordinate=c)
              for c in itertools.product(range(2), range(2))}
    leaves = sh._map(lambda p, leaf, place: (p, leaf, place), params, pl)
    for p, full, place in _flat_leaves(leaves):
        got = {c: _get(blocks[c], p) for c in blocks}
        for i in (1, 0):  # inner mesh dim first
            if isinstance(place[i], Shard):
                got = {c: torch.cat([got[c[:i] + (j,) + c[i + 1:]] for j in range(2)],
                                    place[i].dim) for c in got if c[i] == 0}
        assert all(torch.equal(g, full) for g in got.values()), p
    assert any(isinstance(x, Shard) for _, _, place in _flat_leaves(leaves) for x in place)


def _flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat_leaves(v)]
    return [tree]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_mesh_helpers_read_names_and_sizes(monkeypatch):
    mesh = StandIn((2, 4), ("pod", "data", "model")[-2:])
    assert port_mesh.data_axes(mesh) == ("data",)
    assert port_mesh.mesh_tp(mesh) == 4 and port_mesh.model_axis(mesh) == "model"
    assert port_mesh.data_axes(StandIn((2, 2, 4), ("pod", "data", "model"))) == ("pod", "data")
    monkeypatch.setenv("REPRO_DEBUG_MESH", "2x2")
    seen = {}
    monkeypatch.setattr(port_mesh, "make_mesh",
                        lambda shape, axes, device_type="cuda": seen.update(
                            shape=shape, axes=axes, device=device_type))
    port_mesh.make_production_mesh(device_type="cpu")
    assert seen == {"shape": (2, 2), "axes": ("data", "model"), "device": "cpu"}


# ----------------------------------------------------------------- elastic
@pytest.mark.parametrize("global_batch", [8, 12, 64, 100, 7])
def test_elastic_plan_equals_the_reference(global_batch):
    for alive, mp, per in itertools.product(range(1, 41), (1, 2, 4, 8), (64, 5)):
        kw = dict(alive_chips=alive, model_parallel=mp, global_batch=global_batch,
                  max_per_shard_batch=per, dropped_hosts=(3,))
        try:
            want = dataclasses.asdict(ref_elastic.elastic_plan(**kw))
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="cannot continue"):
                port_elastic.elastic_plan(**kw)
            assert "cannot continue" in str(e)
            continue
        got = port_elastic.elastic_plan(**kw)
        assert dataclasses.asdict(got) == want
        assert got.chips_used == got.data_parallel * got.model_parallel <= alive


def test_rebalance_batch_equals_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        weights = [float(w) for w in rng.random(n) * rng.integers(0, 3, n)]
        gb = int(rng.integers(1, 300))
        if sum(weights) <= 0:
            with pytest.raises(ValueError):
                port_elastic.rebalance_batch(gb, weights)
            continue
        got = port_elastic.rebalance_batch(gb, weights)
        assert got == ref_elastic.rebalance_batch(gb, weights) and sum(got) == gb


# ------------------------------------------------------- dispatch groups
class _Groups:
    """A stub policy: ``groups`` dispatch groups, identity buffers, no mesh."""

    def __init__(self, groups):
        self.groups = groups

    def moe_groups(self, t):
        return self.groups

    def ebuf(self, x):
        return x

    def ebuf_out(self, y):
        return y


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("shared", [False, True], ids=["no-shared", "shared"])
@pytest.mark.parametrize("groups", [2, 4])
def test_moe_dispatch_groups_match_the_reference(groups, shared, cf):
    d, f, e, k = 16, 32, 8, 2
    rp = ref_moe_init(jax.random.PRNGKey(1), d, f, e, "swiglu", shared_expert=shared,
                      dtype=jnp.float32)
    pp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(2).standard_normal((4, 8, d)).astype(np.float32)
    kw = dict(num_experts=e, top_k=k, kind="swiglu", capacity_factor=cf, return_stats=True)
    rout, raux, rstats = ref_moe_apply(rp, jnp.asarray(x), policy=_Groups(groups), **kw)
    out, aux, stats = moe_apply(pp, torch.from_numpy(x), policy=_Groups(groups), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5, rtol=0)
    assert abs(float(aux) - float(raux)) <= 1e-5
    assert stats["groups"] == rstats["groups"] == groups
    assert stats["capacity"] == rstats["capacity"]
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(rstats["expert_load"]))
    assert float(stats["dropped_fraction"]) == pytest.approx(float(rstats["dropped_fraction"]))
    # one group is the ungrouped layer, bitwise
    one = moe_apply(pp, torch.from_numpy(x), policy=_Groups(1), **kw)
    assert torch.equal(one[0], moe_apply(pp, torch.from_numpy(x), **kw)[0])


# ------------------------------------------------------------- refusals
def _policy(mode="tp"):
    return sh.make_policy(StandIn((2, 2)), mode=mode)


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-370m", {}), ("jamba-v0.1-52b", {}), ("qwen3-8b", {"kv_cache_dtype": "int8"}),
], ids=["ssm", "hybrid", "int8-kv"])
@pytest.mark.parametrize("batch", [4, 3])
def test_init_cache_under_a_policy_is_each_rank_s_block(arch, kw, batch):
    """``init_cache(..., policy=)`` makes every leaf at the local shape of its
    ``cache_shardings`` block (K/V and int8 scales L/tp positions of a
    capacity rounded up to the model axis, the SSM state H/tp heads, every
    conv window C/tp channels, rows over "data" when they divide): the
    shapes and dtypes of ``shard_tree``'s blocks of the whole cache, at
    every coordinate."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    full = init_cache(cfg, batch, 16, device="cpu")
    for c in itertools.product(range(2), range(2)):
        mesh = StandIn((2, 2), coordinate=c)
        got = init_cache(cfg, batch, 15, device="cpu", policy=sh.make_policy(mesh))
        pl = sh.cache_shardings(cfg, full, mesh, batch=batch)
        want = sh.shard_tree(full, pl, mesh)
        for g, w in zip(_flat_leaves(got), _flat_leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype and not g.any()
    names = {k for entry in full for k in entry}
    assert names >= ({"ssm", "conv_x", "conv_b", "conv_c"} if arch != "qwen3-8b"
                     else {"k_scale", "v_scale"})


def test_a_mesh_entry_point_needs_the_placements_the_params_were_cut_with():
    cfg = get_config("qwen3-8b", reduced=True)
    params = api.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="carries no param placements"):
        api.model_forward(params, cfg, {"tokens": np.zeros((4, 8), np.int64)}, policy=_policy())
    pl = sh.param_shardings(cfg, api.param_shapes(cfg), StandIn((2, 2)))
    assert _policy().with_placements(pl).param_placements("units", 0) is pl["units"][0]


def test_a_policy_needs_a_model_axis_and_a_known_mode():
    with pytest.raises(ValueError, match="'model' axis"):
        sh.make_policy(StandIn((4,), ("shard",)))
    with pytest.raises(ValueError, match="unknown sharding mode"):
        sh.make_policy(StandIn((2, 2)), mode="pp")


def test_no_policy_hooks_are_the_identity_and_single_device_paths_take_none():
    x = torch.randn(2, 3, 4)
    p = sh.NO_POLICY
    assert p.res(x) is x and p.logits(x) is x and p.ebuf(x) is x and p.ebuf_out(x) is x
    assert p.qkv(x, x, x) == (x, x, x) and p.moe_groups(12) == 1
    assert p.bind(2, 3) is p and p.block_in(x) is x and p.take(x, p.compute_spec()) is x
    assert p.gather_params(x, "units", 0, lead=1) is x and p._coord("model") == 0
    cfg = get_config("qwen3-8b", reduced=True)
    eng = ServeEngine(cfg, max_len=16, device="cpu", generator=torch.Generator().manual_seed(0))
    assert eng.policy is sh.NO_POLICY
