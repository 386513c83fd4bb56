"""The port's LM training path against the reference, on the CPU.

``data/pipeline.py`` bitwise; the attention layer's gradient (through
flash's autograd Function) against ``jax.grad`` of the reference's
``attention``; ``models/api.py::loss_fn`` and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` (the ssm and hybrid
families through the SSD's autograd Function and its plain backward); three
steps of ``make_train_step`` against the reference's; the launcher.

Parameters come from the reference's init and are carried over with
``models.api.params_from_numpy``; inputs are made with numpy. Tolerances:
f32 paths atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46). A step's
params within 0.02 of its lr: AdamW moves a parameter by about
lr · m̂ / sqrt(v̂), which is ±lr on the first step whatever the gradient's
size, so a near-zero gradient whose sign the two packages' rounding decides
moves the two params 2 lr apart; the test allows no such flip and holds
every param to 0.02 lr.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.data import pipeline as ref_pipeline
from repro.models import api as ref_api
from repro.models.lm import attention as ref_attn
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train import train_step as ref_train_step
from repro_torch.configs.base import get_config as port_config
from repro_torch.data import pipeline as port_pipeline
from repro_torch.launch import train as port_launch
from repro_torch.models import api as port_api
from repro_torch.models.lm import attention as port_attn
from repro_torch.models.lm import transformer as port_transformer
from repro_torch.optim.adamw import AdamWConfig, _leaves
from repro_torch.train import train_step as port_train_step
from repro_torch.train.loop import Trainer, TrainerConfig

ATOL, RTOL = 5e-4, 1e-3
LR_UNITS = 0.02  # a step's params, in units of the step's lr
TRAIN_ARCHS = ["qwen2-1.5b", "smollm-360m", "granite-moe-3b-a800m", "qwen2-vl-7b",
               "seamless-m4t-medium", "mamba2-370m", "jamba-v0.1-52b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch):
    return ref_config(arch, reduced=True), port_config(arch, reduced=True)


def _params(rcfg, pcfg, seed=0):
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(seed))
    return rp, port_api.params_from_numpy(pcfg, _np(rp), device="cpu")


def _batch(cfg, *, seed=0, step=0, batch=2, seq=24):
    return ref_pipeline.synthetic_batch(seed=seed, step=step, batch=batch, seq=seq,
                                        vocab=cfg.vocab_size, family=cfg.family,
                                        d_model=cfg.d_model)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("family,d_model", [("dense", 0), ("audio", 24), ("vlm", 24),
                                            ("moe", 0)])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synthetic_batch_is_bitwise_the_reference(family, d_model, seed, step):
    kw = dict(seed=seed, step=step, batch=3, seq=17, vocab=501, family=family, d_model=d_model)
    want = ref_pipeline.synthetic_batch(**kw)
    got = port_pipeline.synthetic_batch(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    stream = port_pipeline.synthetic_batches(start_step=step, **{
        k: v for k, v in kw.items() if k != "step"})
    assert np.array_equal(next(stream)["labels"], want["labels"])


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal", [True, False])
def test_attention_module_gradient_matches_reference(causal):
    """``models/lm/attention.attention`` (QKV bias, RoPE, GQA 6/2) under
    grad: its params' and its input's gradient against ``jax.grad`` of the
    reference's ``attention`` on its ``chunked`` and ``xla`` paths."""
    d, h, kv, hd, s = 48, 6, 2, 16, 40
    rng = np.random.default_rng(11)
    p = {"wq": rng.standard_normal((d, h * hd)), "wk": rng.standard_normal((d, kv * hd)),
         "wv": rng.standard_normal((d, kv * hd)), "wo": rng.standard_normal((h * hd, d)),
         "bq": rng.standard_normal(h * hd), "bk": rng.standard_normal(kv * hd),
         "bv": rng.standard_normal(kv * hd)}
    p = {k: (a * 0.15).astype(np.float32) for k, a in p.items()}
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    st = port_attn.AttnStatics(h, kv, hd, causal=causal)
    out = port_attn.attention(tp, tx, st, torch.from_numpy(pos.copy()))
    keys = sorted(p)
    got = torch.autograd.grad(out.square().sum(), [tp[k] for k in keys] + [tx])
    for impl in ("chunked", "xla"):
        rst = ref_attn.AttnStatics(h, kv, hd, causal=causal, impl=impl, chunk=16)

        def f(pp, xx):
            return jnp.sum(ref_attn.attention(pp, xx, rst, jnp.asarray(pos)) ** 2)

        gp, gx = jax.grad(f, argnums=(0, 1))({k: jnp.asarray(a) for k, a in p.items()},
                                              jnp.asarray(x))
        for g, w in zip(got, [gp[k] for k in keys] + [gx]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    rcfg, pcfg = _pair(arch)
    rp, pp = _params(rcfg, pcfg, seed=1)
    b = _batch(rcfg, seed=2)
    b["labels"][0, :3] = -1  # ignored positions
    (rloss, rm), rgrads = jax.value_and_grad(ref_api.loss_fn, has_aux=True)(
        rp, rcfg, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = [t.requires_grad_() for t in _leaves(pp)]
    loss, metrics = port_api.loss_fn(pp, pcfg, _torch_batch(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss), float(rloss), atol=ATOL, rtol=RTOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(rm[k]), atol=ATOL, rtol=RTOL)
    assert float(metrics["tokens"]) == b["labels"].size - 3
    if arch.startswith("granite"):
        assert float(metrics["aux"]) > 0  # the MoE aux loss is in the loss
    ref_leaves = jax.tree_util.tree_leaves(rgrads)
    assert len(ref_leaves) == len(grads)
    for g, w in zip(grads, ref_leaves):
        g = torch.zeros(w.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_loss_masks_the_padded_vocab_tail():
    """Columns past ``vocab_size`` (a padded vocab) take no probability: the
    loss equals the loss over the first ``vocab_size`` columns alone."""
    rcfg, pcfg = _pair("smollm-360m")
    pcfg = dataclasses.replace(pcfg, vocab_size=500)  # the table keeps 512 rows
    rcfg = dataclasses.replace(rcfg, vocab_size=500)
    rp = ref_api.model_init(dataclasses.replace(rcfg, vocab_size=512), jax.random.PRNGKey(0))
    pp = port_api.params_from_numpy(dataclasses.replace(pcfg, vocab_size=512), _np(rp),
                                    device="cpu")
    b = _batch(rcfg)
    want = ref_api.loss_fn(rp, rcfg, {k: jnp.asarray(v) for k, v in b.items()})[0]
    got = port_api.loss_fn(pp, pcfg, _torch_batch(b))[0]
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    logits = port_api.model_forward(pp, pcfg, _torch_batch(b))[0][..., :500]
    lab = torch.from_numpy(b["labels"]).long()
    direct = torch.nn.functional.cross_entropy(logits.reshape(-1, 500), lab.reshape(-1))
    np.testing.assert_allclose(float(got), float(direct), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m", "mamba2-370m"])
def test_three_train_steps_match_reference(arch):
    rcfg, pcfg = _pair(arch)
    rp, pp = _params(rcfg, pcfg, seed=3)
    kw = dict(total_steps=20, warmup=2)
    ropt, popt = RefAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    rstep = jax.jit(ref_train_step.make_train_step(rcfg, ropt, **kw))
    pstep = port_train_step.make_train_step(pcfg, popt, **kw)
    rs = ref_train_step.init_train_state(rcfg, rp)
    ps = port_train_step.init_train_state(pcfg, pp)
    for i in range(3):
        b = _batch(rcfg, seed=0, step=i)
        rs, rm = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, _torch_batch(b))
        lr = float(rm["lr"])
        assert float(pm["lr"]) == lr > 0
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), atol=ATOL, rtol=RTOL)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        assert int(ps["opt"].step) == int(rs["opt"].step) == i + 1
        for g, w in zip(_leaves(ps["params"]), jax.tree_util.tree_leaves(rs["params"])):
            assert g.requires_grad
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=LR_UNITS * lr,
                                       rtol=0)


def test_serve_step_is_a_greedy_decode_step():
    rcfg, pcfg = _pair("smollm-360m")
    _, pp = _params(rcfg, pcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 5)))
    logits, cache, n = port_api.model_prefill(pp, pcfg, {"tokens": toks}, 8)
    nxt, step_logits, _ = port_train_step.make_serve_step(pcfg)(
        pp, {"tokens": logits[:, -1].argmax(-1, keepdim=True)}, cache, n)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2,)
    assert torch.equal(nxt, step_logits.argmax(-1).to(torch.int32))


def test_trainer_loss_drops_on_the_affine_task():
    cfg = port_config("smollm-360m", reduced=True)
    t = TrainerConfig(steps=30, batch=4, seq=16, log_every=1, warmup=3,
                      opt=AdamWConfig(lr=3e-3))
    out = Trainer(cfg, t, device="cpu").run()
    losses = [r["loss"] for r in out["metrics"]]
    assert len(losses) == 30 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.3


def test_unbind_gives_each_unit_and_stacks_its_gradient():
    """The layer stacks are split once a forward: every unit's leaves are
    views of the stacked ones, and each stacked leaf's gradient is its
    units' gradients in order."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(3, 4, 5, generator=gen, requires_grad=True)
    b = torch.randn(3, 5, generator=gen, requires_grad=True)
    units = port_transformer._unbind({"w": w, "inner": {"b": b}}, 3)
    assert len(units) == 3
    for u, p in enumerate(units):
        assert torch.equal(p["w"], w[u]) and torch.equal(p["inner"]["b"], b[u])
    loss = sum((u + 1) * (p["w"].sum(0) * p["inner"]["b"]).sum() for u, p in enumerate(units))
    gw, gb = torch.autograd.grad(loss, [w, b])
    k = torch.arange(1, 4, dtype=torch.float32)
    torch.testing.assert_close(gw, (k[:, None] * b.detach())[:, None, :].expand(3, 4, 5))
    torch.testing.assert_close(gb, k[:, None] * w.detach().sum(1))


def test_launcher_trains_two_steps_on_cpu(capsys):
    out = port_launch.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "16"])
    assert int(out["state"]["step"]) == 2
    assert "step     2  loss" in capsys.readouterr().out


def test_launcher_trains_the_ssm_family_on_cpu(capsys):
    """``launch.train --arch mamba2-370m --device cpu``: the SSD's autograd
    Function on CPU tensors (its plain backward), no kernel launched."""
    from repro_torch.kernels import build

    build.reset_launch_counts()
    out = port_launch.main(["--arch", "mamba2-370m", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "40"])
    assert int(out["state"]["step"]) == 2 and build.launch_counts() == {}
    assert all(math.isfinite(r["loss"]) for r in out["metrics"])
    assert "step     2  loss" in capsys.readouterr().out
