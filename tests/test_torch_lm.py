"""The port's LM stack against the reference, on the CPU: configs and
parameters of every LM config, and forward / prefill / decode of every
REDUCED dense and ssm config (the layers alone are in
``test_torch_lm_modules.py``, the MoE and hybrid stacks in
``test_torch_moe.py``, the VLM in ``test_torch_vlm.py``, the enc-dec in
``test_torch_encdec.py``).

Parameters come from the reference's own init (``jax.random``) and are
carried into the port with ``models.api.params_from_numpy``; inputs are made
with numpy from a seed. The port runs its kernels' plain versions here.

Tolerances: f32 paths atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46),
caches compared leaf by leaf at the same tolerance. bf16 paths: see
``test_bf16_forward_matches_reference_flash_path``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_config as port_config
from repro_torch.configs.base import list_configs
from repro_torch.kernels import build
from repro_torch.models import api as port_api

ATOL, RTOL = 5e-4, 1e-3
DENSE = ["qwen3-8b", "qwen2-1.5b", "smollm-360m", "nemotron-4-15b"]
STACK_ARCHS = DENSE + ["mamba2-370m"]  # forward/prefill/decode here
LM_ARCHS = STACK_ARCHS + ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b",
                          "jamba-v0.1-52b", "qwen2-vl-7b", "seamless-m4t-medium"]

# Fields of the reference's ModelConfig the port leaves out: the XLA knob,
# the attention switch (the device picks kernel or plain version), and the
# Pallas switch of the GNN engine.
LEFT_OUT = {"attention_impl", "scan_layers", "gnn_use_kernel"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(rcfg, pcfg, seed=0):
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(seed))
    return rp, port_api.params_from_numpy(pcfg, _np(rp), device="cpu")


def _pair(arch, **overrides):
    return (dataclasses.replace(ref_config(arch, reduced=True), **overrides),
            dataclasses.replace(port_config(arch, reduced=True), **overrides))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _cache_leaves(cache):
    """Leaves of a port cache in the reference's tree order (sorted keys)."""
    return [c[k] for c in cache for k in sorted(c)]


def _assert_caches_close(got, want):
    ref_leaves = jax.tree_util.tree_leaves(want)
    port_leaves = _cache_leaves(got)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        if r.dtype == jnp.int8:  # one rounding step apart at most
            assert p.dtype == torch.int8
            assert np.abs(p.numpy().astype(np.int32) - np.asarray(r, np.int32)).max() <= 1
        else:
            _close(p, r)


# ------------------------------------------------------------------ configs
def test_port_leaves_out_only_the_named_reference_fields():
    ref = {f.name for f in dataclasses.fields(RefModelConfig)}
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    assert port <= ref
    assert ref - port == LEFT_OUT


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_match_reference_on_shared_fields(arch, reduced):
    ref, port = ref_config(arch, reduced=reduced), port_config(arch, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    for prop in ("resolved_head_dim", "d_inner", "ssm_heads", "is_ssm_only", "is_moe",
                 "is_hybrid"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.padded_vocab(1) == ref.padded_vocab(1)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shapes_match_reference_init(arch, reduced):
    """``param_shapes`` is the tree of the reference's own params (FULL ones
    traced abstractly, nothing allocated), and the port's init gives it."""
    rcfg, pcfg = ref_config(arch, reduced=reduced), port_config(arch, reduced=reduced)
    ref = jax.eval_shape(lambda: ref_api.model_init(rcfg, jax.random.PRNGKey(0)))
    want = port_api.param_shapes(pcfg)
    assert want == jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    if reduced:
        own = port_api.model_init(pcfg, device="cpu")
        assert want == jax.tree_util.tree_map(lambda a: tuple(a.shape), own)
        rdt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: str(a.dtype), ref))
        pdt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda t: str(t.dtype).replace("torch.", ""), own))
        assert pdt == rdt


def test_unported_families_are_refused():
    """Every token family of the registry initialises (REDUCED, on the CPU,
    to the reference's tree); a family the registry does not have is
    refused, and a GNN config has no token cache."""
    families = set()
    for arch in list_configs():
        cfg = port_config(arch, reduced=True)
        if cfg.family == "gnn":
            continue
        families.add(cfg.family)
        params = port_api.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
            port_api.param_shapes(cfg)
    assert families == {"dense", "moe", "hybrid", "ssm", "vlm", "audio"}
    for family in ("diffusion", "vision"):
        cfg = dataclasses.replace(port_config("qwen3-8b", reduced=True), family=family)
        with pytest.raises(ValueError, match="not a token family"):
            port_api.model_init(cfg, device="cpu")
    gnn = port_config("ample-gcn", reduced=True)
    with pytest.raises(TypeError, match="no token cache"):
        port_api.model_prefill({}, gnn, {"tokens": torch.zeros((1, 2))}, 4)


def test_params_from_numpy_keeps_bf16_bitwise():
    rcfg, pcfg = _pair("qwen3-8b", dtype="bfloat16")
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(3))
    pp = port_api.params_from_numpy(pcfg, _np(rp), device="cpu")
    leaves = jax.tree_util.tree_leaves(rp)
    ported = jax.tree_util.tree_leaves(pp)
    assert any(r.dtype == jnp.bfloat16 for r in leaves)
    for r, p in zip(leaves, ported):
        if r.dtype == jnp.bfloat16:
            assert p.dtype == torch.bfloat16
            assert np.array_equal(p.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(r).view(np.uint16))
        else:
            assert p.dtype == torch.float32 and np.array_equal(p.numpy(), np.asarray(r))
    bad = _np(rp)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="weights must be"):
        port_api.params_from_numpy(pcfg, bad, device="cpu")


# -------------------------------------------------------------- whole stack
@pytest.fixture(scope="module", params=STACK_ARCHS)
def stack(request):
    rcfg, pcfg = _pair(request.param)
    rp, pp = _params(rcfg, pcfg, seed=1)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 37)).astype(np.int32)
    return rcfg, pcfg, rp, pp, toks


def test_forward_matches_reference(stack):
    rcfg, pcfg, rp, pp, toks = stack
    rl, _ = ref_api.model_forward(rp, rcfg, {"tokens": jnp.asarray(toks)})
    pl, aux = port_api.model_forward(pp, pcfg, {"tokens": torch.from_numpy(toks)})
    assert pl.dtype == torch.float32 and tuple(pl.shape) == rl.shape and float(aux) == 0.0
    _close(pl, rl)


def test_prefill_and_decode_match_reference(stack):
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


def test_int8_kv_prefill_and_decode_match_reference():
    rcfg, pcfg = _pair("qwen3-8b", kv_cache_dtype="int8")
    rp, pp = _params(rcfg, pcfg, seed=4)
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    rl, rcache, rn = ref_api.model_prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, 20)
    pl, pcache, pn = port_api.model_prefill(pp, pcfg, {"tokens": torch.from_numpy(toks)}, 20)
    _close(pl, rl)
    _assert_caches_close(pcache, rcache)
    rd, _ = ref_api.model_decode_step(rp, rcfg, {"tokens": jnp.ones((2, 1), jnp.int32)}, rcache, rn)
    pd, _ = port_api.model_decode_step(pp, pcfg, {"tokens": torch.ones((2, 1), dtype=torch.int64)},
                                       pcache, pn)
    _close(pd, rd)


def test_bf16_forward_matches_reference_flash_path():
    """REDUCED qwen3-8b in bf16 against the reference's flash path (Pallas,
    interpret), which keeps scores and probabilities in f32 as the port does.
    Every matmul rounds its output to bf16 (8 significant bits); summed in
    another order, an output near a rounding boundary lands one bf16 ulp
    away, and three layers carry a few such steps into the logits, which
    are themselves bf16. So the logits agree within 4 bf16 ulps of the
    largest logit, and their argmax at 90% of positions
    (tests/test_int8_kv.py:40)."""
    rcfg, pcfg = _pair("qwen3-8b", dtype="bfloat16")
    rcfg = dataclasses.replace(rcfg, attention_impl="flash")
    rp, pp = _params(rcfg, pcfg, seed=1)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 37)).astype(np.int32)
    rl = np.asarray(ref_api.model_forward(rp, rcfg, {"tokens": jnp.asarray(toks)})[0])
    pl = port_api.model_forward(pp, pcfg, {"tokens": torch.from_numpy(toks)})[0].numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(rl).max())) - 7)
    assert np.abs(pl - rl).max() <= 4 * ulp
    assert (pl.argmax(-1) == rl.argmax(-1)).mean() >= 0.9
