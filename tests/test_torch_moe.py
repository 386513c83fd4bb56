"""The port's MoE layer and the ``moe`` and ``hybrid`` LM families against the
reference, on the CPU.

``moe_apply`` is held against the reference's ``repro/models/lm/moe.py``
(parameters from its ``moe_init``), then the reference's own properties
(``tests/test_moe.py``) are checked on the port; the REDUCED Granite-MoE,
Llama-4 Maverick and Jamba configs run ``forward``, ``prefill`` and
``decode_step`` against the reference's, with parameters from the
reference's init carried over by ``models.api.params_from_numpy``. Inputs
are made with numpy from a seed.

Tolerances: f32 outputs atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46);
the aux loss within 1e-6 (a sum of E products of f32 means); expert loads,
capacities and dropped fractions exactly (integer counts, and one f32
division of the same integers).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro.models.lm.moe import moe_apply as ref_moe_apply
from repro.models.lm.moe import moe_init as ref_moe_init
from repro_torch.configs.base import get_config as port_config
from repro_torch.models import api as port_api
from repro_torch.models.lm.mlp import mlp_apply
from repro_torch.models.lm.moe import moe_apply
from repro_torch.models.lm.transformer import block_roles
from repro_torch.serve.engine import ServeEngine

ATOL, RTOL = 5e-4, 1e-3
AUX_ATOL = 1e-6
D, F = 16, 32
MOE_ARCHS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.lru_cache(maxsize=None)
def _ref_params(e, kind, shared):
    return ref_moe_init(jax.random.PRNGKey(e), D, F, e, kind, shared_expert=shared,
                        dtype=jnp.float32)


def _layer(e, kind, shared, seed, t=32):
    """Reference MoE params (f32, one set per layer shape) and an input
    [2, t/2, D] from ``seed``, in both packages."""
    rp = _ref_params(e, kind, shared)
    x = np.random.default_rng(seed).standard_normal((2, t // 2, D)).astype(np.float32)
    return rp, _torch(rp), x


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _cache_leaves(cache):
    """Leaves of a port cache in the reference's tree order (sorted keys)."""
    return [c[k] for c in cache for k in sorted(c)]


def _assert_caches_close(got, want):
    """Leaf by leaf at the f32 tolerance (the REDUCED configs keep no int8
    cache here)."""
    ref_leaves = jax.tree_util.tree_leaves(want)
    port_leaves = _cache_leaves(got)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        _close(p, r)


# Compiled once per static configuration (eager dispatch compiles every op
# at every new shape).
_ref_moe_apply = jax.jit(ref_moe_apply, static_argnames=(
    "num_experts", "top_k", "kind", "capacity_factor", "return_stats"))


def _check_layer(e, k, t, cf, kind, shared, seed):
    rp, pp, x = _layer(e, kind, shared, seed, t)
    kw = dict(num_experts=e, top_k=k, kind=kind, capacity_factor=cf, return_stats=True)
    rout, raux, rstats = _ref_moe_apply(rp, jnp.asarray(x), **kw)
    out, aux, stats = moe_apply(pp, torch.from_numpy(x), **kw)
    assert out.shape == rout.shape and out.dtype == torch.float32
    _close(out, rout)
    assert abs(float(aux) - float(raux)) <= AUX_ATOL
    assert stats["expert_load"].dtype == torch.int32
    np.testing.assert_array_equal(stats["expert_load"].numpy(), np.asarray(rstats["expert_load"]))
    assert float(stats["dropped_fraction"]) == float(rstats["dropped_fraction"])
    assert stats["capacity"] == rstats["capacity"] and stats["groups"] == rstats["groups"] == 1


# ------------------------------------------------------------------ the layer
@pytest.mark.parametrize("cf", [0.25, 1.25, "E"])
@pytest.mark.parametrize("t", [8, 32])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("e", [4, 8])
def test_moe_apply_matches_reference(e, k, t, cf):
    """SwiGLU experts over the grid of experts, top-k, tokens and capacity
    factors (cf = E: no slot can drop); top-1 with a shared expert, as
    Llama-4's layers, top-2 without, as Jamba's."""
    _check_layer(e, k, t, float(e) if cf == "E" else cf, "swiglu", k == 1, seed=e + k + t)


@pytest.mark.parametrize("shared", [False, True], ids=["no-shared", "shared"])
@pytest.mark.parametrize("cf", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("kind", ["relu2", "gelu"])
def test_moe_apply_other_mlp_kinds_match_reference(kind, cf, shared):
    _check_layer(8, 2, 32, cf, kind, shared, seed=3)


@pytest.mark.parametrize("e,k,t", [(4, 1, 8), (4, 2, 32), (8, 1, 32), (8, 2, 8)])
def test_no_drop_equals_per_token_sum(e, k, t):
    """At cf = E no slot drops, so each token's output is the gate-weighted
    sum of its experts' FFNs (tests/test_moe.py:20-40)."""
    _, pp, x = _layer(e, "swiglu", False, seed=10 + e + k, t=t)
    xf = torch.from_numpy(x).reshape(t, D)
    out, _ = moe_apply(pp, xf[None], num_experts=e, top_k=k, kind="swiglu",
                       capacity_factor=float(e))
    w, idx = torch.topk(torch.softmax(xf @ pp["router"], -1), k)
    w = w / w.sum(-1, keepdim=True)
    want = torch.zeros((t, D))
    for tt in range(t):
        for j in range(k):
            ep = {n: a[idx[tt, j]] for n, a in pp["experts"].items()}
            want[tt] += w[tt, j] * mlp_apply(ep, xf[tt : tt + 1], "swiglu")[0]
    np.testing.assert_allclose(out.reshape(t, D).numpy(), want.numpy(), atol=1e-4)


def test_capacity_drops_monotone():
    """A lower capacity factor can only drop more slots; an ample one drops
    none (tests/test_moe.py:43-56)."""
    _, pp, x = _layer(8, "swiglu", False, seed=0, t=64)
    dropped = [float(moe_apply(pp, torch.from_numpy(x), num_experts=8, top_k=2, kind="swiglu",
                               capacity_factor=cf, return_stats=True)[2]["dropped_fraction"])
               for cf in (0.25, 1.0, 8.0)]
    assert dropped[0] >= dropped[1] >= dropped[2] == 0.0
    assert dropped[0] > 0.0


def test_stats_expert_load_conserved():
    """Every (token, k) slot is counted once (tests/test_moe.py:59-65)."""
    _, pp, x = _layer(4, "swiglu", False, seed=2, t=32)
    _, _, stats = moe_apply(pp, torch.from_numpy(x), num_experts=4, top_k=2, kind="swiglu",
                            capacity_factor=4.0, return_stats=True)
    assert int(stats["expert_load"].sum()) == 32 * 2
    # the routes and probabilities returned beside the loads agree with them
    assert stats["gate_idx"].shape == (32, 2) and stats["probs"].shape == (32, 4)
    assert torch.equal(torch.bincount(stats["gate_idx"].flatten(), minlength=4).int(),
                       stats["expert_load"])
    torch.testing.assert_close(stats["probs"].sum(-1), torch.ones(32))


def test_moe_apply_is_bitwise_repeatable():
    _, pp, x = _layer(8, "swiglu", True, seed=4, t=32)
    kw = dict(num_experts=8, top_k=2, kind="swiglu", capacity_factor=1.25)
    a, aux_a = moe_apply(pp, torch.from_numpy(x), **kw)
    b, aux_b = moe_apply(pp, torch.from_numpy(x), **kw)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# -------------------------------------------------------------- whole stacks
def test_block_roles_match_reference():
    from repro.models.lm.transformer import block_roles as ref_roles

    for arch in MOE_ARCHS:
        for reduced in (False, True):
            assert block_roles(port_config(arch, reduced=reduced)) == ref_roles(
                ref_config(arch, reduced=reduced))
    jamba = block_roles(port_config("jamba-v0.1-52b"))
    assert [m for m, _ in jamba].count("attn") == 1 and jamba[4] == ("attn", "dense")
    assert [f for _, f in jamba] == ["dense", "moe"] * 4


def test_router_stays_f32_in_a_bf16_model():
    """The router is f32 whatever the model dtype: carried over from the
    reference bit for bit, and made so by the port's own init."""
    rcfg, pcfg = (dataclasses.replace(get("llama4-maverick-400b-a17b", reduced=True),
                                      dtype="bfloat16") for get in (ref_config, port_config))
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(5))
    for pp in (port_api.params_from_numpy(pcfg, _np(rp), device="cpu"),
               port_api.model_init(pcfg, torch.Generator().manual_seed(0), device="cpu")):
        moe = pp["units"][1]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["experts"]["w_gate"].dtype == moe["shared"]["w_up"].dtype == torch.bfloat16
        assert tuple(moe["experts"]["w_down"].shape) == (pcfg.num_layers // 2, pcfg.num_experts,
                                                         pcfg.d_ff, pcfg.d_model)
    np.testing.assert_array_equal(
        port_api.params_from_numpy(pcfg, _np(rp), device="cpu")["units"][1]["moe"]["router"]
        .numpy(), np.asarray(rp["units"][1]["moe"]["router"]))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def stack(request):
    rcfg, pcfg = ref_config(request.param, reduced=True), port_config(request.param, reduced=True)
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(1))
    pp = port_api.params_from_numpy(pcfg, _np(rp), device="cpu")
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 37)).astype(np.int32)
    return rcfg, pcfg, rp, pp, toks


def test_forward_and_aux_match_reference(stack):
    rcfg, pcfg, rp, pp, toks = stack
    rl, raux = ref_api.model_forward(rp, rcfg, {"tokens": jnp.asarray(toks)})
    pl, aux = port_api.model_forward(pp, pcfg, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == torch.float32 and tuple(pl.shape) == rl.shape
    _close(pl, rl)
    assert float(raux) > 0.0 and abs(float(aux) - float(raux)) <= AUX_ATOL


def test_prefill_and_decode_match_reference(stack):
    """At the config's capacity factor: decode's 2 tokens a step drop what
    the reference's drop (cap 1 for every config here)."""
    rcfg, pcfg, rp, pp, toks = stack
    rl, rcache, rn = ref_api.model_prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, 48)
    pl, pcache, pn = port_api.model_prefill(pp, pcfg, {"tokens": torch.from_numpy(toks)}, 48)
    assert pn == int(rn) == 37
    _close(pl, rl)
    _assert_caches_close(pcache, rcache)
    empty = port_api.model_init_cache(pcfg, pp, {"tokens": toks}, 48)
    assert [tuple(t.shape) for t in _cache_leaves(empty)] == [
        a.shape for a in jax.tree_util.tree_leaves(rcache)]
    for step in range(3):
        tok = toks[:, step : step + 1]
        rd, rcache = ref_api.model_decode_step(rp, rcfg, {"tokens": jnp.asarray(tok)}, rcache,
                                               rn + step)
        pd, pcache = port_api.model_decode_step(pp, pcfg, {"tokens": torch.from_numpy(tok)},
                                                pcache, pn + step)
        _close(pd, rd)
        _assert_caches_close(pcache, rcache)


def test_jamba_cache_holds_one_kv_entry_and_seven_mamba_states():
    cfg = port_config("jamba-v0.1-52b", reduced=True)
    cache = port_api.model_init_cache(cfg, {"embed": torch.zeros(1)}, {"tokens": np.zeros((3, 1))},
                                      16)
    assert [sorted(c) for c in cache].count(["k", "v"]) == 1
    assert sum("ssm" in c for c in cache) == 7
    assert tuple(cache[4]["k"].shape) == (1, 3, 16, cfg.num_kv_heads, cfg.resolved_head_dim)


# ------------------------------------------------------------ jamba serving
@pytest.fixture(scope="module")
def jamba_nodrop():
    """REDUCED Jamba at cf 64: no slot drops at any batch, so decode and the
    full forward route alike (tests/test_serve.py:19-22)."""
    cfg = dataclasses.replace(port_config("jamba-v0.1-52b", reduced=True), capacity_factor=64.0)
    params = port_api.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def test_jamba_generate_matches_stepwise_argmax(jamba_nodrop):
    """ServeEngine output == greedy decoding through full forwards
    (tests/test_serve.py:26-40)."""
    cfg, params = jamba_nodrop
    eng = ServeEngine(cfg, params, max_len=48, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    out = eng.generate(prompts, max_new_tokens=6)
    seq = torch.from_numpy(prompts).long()
    for _ in range(6):
        logits, _ = port_api.model_forward(params, cfg, {"tokens": seq})
        seq = torch.cat([seq, torch.argmax(logits[:, -1, : cfg.vocab_size], -1)[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


def test_jamba_int8_kv_close_to_model_dtype_cache(jamba_nodrop):
    """int8 KV cache vs the model-dtype cache (tests/test_int8_kv.py:15-45):
    relative logit error < 0.05 and top-1 agreement >= 90%."""
    cfg, params = jamba_nodrop
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)))

    def run(c):
        logits, cache, n = port_api.model_prefill(params, c, {"tokens": toks}, 24)
        out = [logits[:, -1]]
        for t in range(4):
            lg, cache = port_api.model_decode_step(
                params, c, {"tokens": torch.ones((2, 1), dtype=torch.long)}, cache, n + t)
            out.append(lg)
        return torch.stack(out)

    full, q8 = run(cfg), run(cfg8)
    rel = float((full - q8).abs().max() / (full.abs().max() + 1e-9))
    assert 0 < rel < 0.05
    assert float((full.argmax(-1) == q8.argmax(-1)).float().mean()) >= 0.9
