"""``remat="block"``: activation checkpointing of the LM units.

The port wraps each unit of a training forward in
``torch.utils.checkpoint`` as the reference wraps its unit in
``jax.checkpoint``. On the CPU the recompute runs the same operations on the
same inputs, so a checkpointed step's loss and gradients are bitwise an
unchecked one's; against the reference (with its own ``remat="block"``)
they are held at the f32 tolerance (``tests/test_gnn_models.py:46``).
Prefill and decode never checkpoint. The configs that set ``"block"`` and
the analytic model that reads it are the reference's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.data import pipeline as ref_pipeline
from repro.models import api as ref_api
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch import analytic
from repro_torch.models import api as port_api
from repro_torch.models.lm import transformer
from repro_torch.optim.adamw import _leaves

ATOL, RTOL = 5e-4, 1e-3
REMAT_ARCHS = {"qwen3-8b", "nemotron-4-15b", "qwen2-vl-7b", "llama4-maverick-400b-a17b",
               "jamba-v0.1-52b"}
# dense, MoE, interleaved MoE, hybrid, VLM (embeds) and the ssm family
ARCHS = ["qwen3-8b", "granite-moe-3b-a800m", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
         "qwen2-vl-7b", "mamba2-370m"]
LM_ARCHS = [a for a in list_configs() if get_config(a).family not in ("gnn", "audio")]


def _case(arch, remat, seed=0):
    """(ref cfg, port cfg, ref params, port params, batch) at REDUCED widths."""
    rcfg = dataclasses.replace(ref_config(arch, reduced=True), remat=remat)
    pcfg = dataclasses.replace(get_config(arch, reduced=True), remat=remat)
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(seed))
    pp = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    b = ref_pipeline.synthetic_batch(seed=seed, step=0, batch=2, seq=24,
                                     vocab=rcfg.vocab_size, family=rcfg.family,
                                     d_model=rcfg.d_model)
    return rcfg, pcfg, rp, pp, b


def _port_loss_and_grads(pcfg, pp, b):
    leaves = [t.detach().clone().requires_grad_() for t in _leaves(pp)]
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(pp), leaves)
    loss, metrics = port_api.loss_fn(params, pcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [loss.detach(), metrics["aux"].detach()] + [
        torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]


@pytest.mark.parametrize("arch", ARCHS)
def test_block_remat_gradients_are_bitwise_the_unchecked_ones(arch):
    _, pcfg, _, pp, b = _case(arch, "none")
    plain = _port_loss_and_grads(pcfg, pp, b)
    remat = _port_loss_and_grads(dataclasses.replace(pcfg, remat="block"), pp, b)
    assert len(plain) == len(remat)
    assert all(torch.equal(a, c) for a, c in zip(plain, remat))
    assert any(float(g.abs().max()) > 0 for g in remat[2:])


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-3b-a800m", "jamba-v0.1-52b"])
def test_block_remat_gradients_match_reference_block_remat(arch):
    rcfg, pcfg, rp, pp, b = _case(arch, "block")
    (rloss, rm), rgrads = jax.value_and_grad(ref_api.loss_fn, has_aux=True)(
        rp, rcfg, {k: jnp.asarray(v) for k, v in b.items()})
    got = _port_loss_and_grads(pcfg, pp, b)
    np.testing.assert_allclose(float(got[0]), float(rloss), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(got[1]), float(rm["aux"]), atol=ATOL, rtol=RTOL)
    want = jax.tree_util.tree_leaves(rgrads)
    assert len(want) == len(got) - 2
    for g, w in zip(got[2:], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_only_a_training_forward_checkpoints(monkeypatch):
    """One checkpoint a unit under grad; none under no_grad, in prefill (even
    under grad: it writes the cache) or in decode (its own pass, which reads
    and writes the cache at a host ``cache_len``)."""
    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    _, pcfg, _, pp, b = _case("llama4-maverick-400b-a17b", "block")
    for t in _leaves(pp):
        t.requires_grad_()
    tokens = torch.from_numpy(b["tokens"])
    port_api.model_forward(pp, pcfg, {"tokens": tokens})[0].sum().backward()
    units = pcfg.num_layers // len(transformer.block_roles(pcfg))
    assert calls == [False] * units
    calls.clear()
    with torch.no_grad():
        port_api.model_forward(pp, pcfg, {"tokens": tokens})
    logits, cache, n = port_api.model_prefill(pp, pcfg, {"tokens": tokens}, 32)
    assert logits.requires_grad
    with torch.no_grad():
        port_api.model_decode_step(pp, pcfg, {"tokens": tokens[:, :1]}, cache, n)
    assert calls == []


def test_remat_configs_are_the_references():
    """The five FULL configs the reference checkpoints set ``"block"``; every
    other config (and every REDUCED one) keeps ``"none"``."""
    for arch in list_configs():
        for reduced in (False, True):
            want = "block" if arch in REMAT_ARCHS and not reduced else "none"
            assert get_config(arch, reduced=reduced).remat == want, (arch, reduced)
            assert ref_config(arch, reduced=reduced).remat == want, (arch, reduced)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_analytic_train_step_reads_remat(arch):
    """A train step counts the forward 3× without remat and 4× with it; the
    other shapes do not read it."""
    cfg = get_config(arch)
    other = dataclasses.replace(cfg, remat="none" if cfg.remat == "block" else "block")
    for shape in SHAPES.values():
        a, b = analytic.step_flops(cfg, shape), analytic.step_flops(other, shape)
        if shape.kind != "train":
            assert a == b
            continue
        none, block = (a, b) if cfg.remat == "none" else (b, a)
        np.testing.assert_allclose(block / none, 4.0 / 3.0, rtol=1e-12)
