"""The port's gradient compression against the reference's, on the CPU.

``TopKCompressor`` is bitwise the reference's; ``int8_leaf`` fed the
reference's uniform draws (``jax.random.uniform(fold_in(PRNGKey(seed), i),
shape)``) is bitwise the reference's ``Int8Compressor``; the port's own draws
keep the error bounded and the rounding unbiased. Then the compressors in
the train step (three REDUCED steps against the reference's
``make_train_step(compressor=...)``, at ``test_torch_train.py``'s
tolerances), in checkpoints either package restores, in the Trainer's crash
and resume, and behind the launcher's ``--compress``. Inputs are made with
numpy from a seed.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs.base import get_config as ref_config
from repro.distributed import compression as ref_comp
from repro.models import api as ref_api
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train import train_step as ref_train_step
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config as port_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.distributed.compression import (
    Int8Compressor,
    TopKCompressor,
    int8_leaf,
    wire_bytes_ratio,
)
from repro_torch.launch import train as port_launch
from repro_torch.models import api as port_api
from repro_torch.optim.adamw import AdamWConfig, _leaves
from repro_torch.train import train_step as port_train_step
from repro_torch.train.loop import Trainer, TrainerConfig

ATOL, RTOL = 5e-4, 1e-3  # tests/test_torch_train.py
LR_UNITS = 0.02  # a step's params, in units of the step's lr (tests/test_torch_train.py)
SHAPES = ((64, 32), (128,), (3, 5, 7))


def _trees(seed, dtype=np.float32):
    """The same gradient tree for both packages: (jax, torch)."""
    rng = np.random.default_rng(seed)
    leaves = {f"w{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(SHAPES)}
    # ties at a top-k threshold: a block of equal magnitudes
    leaves["w0"][:4, :4] = 1.75 * np.sign(leaves["w0"][:4, :4])
    if dtype != np.float32:
        leaves = {k: v.astype(ml_dtypes.bfloat16) for k, v in leaves.items()}
    jt = {k: jnp.asarray(v) for k, v in leaves.items()}
    pt = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
              if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
          for k, v in leaves.items()}
    return jt, pt


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bitwise(port_tree, ref_tree):
    got, want = _leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def _ref_draws(seed, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
    return torch.from_numpy(np.array(jax.random.uniform(key, tuple(shape))))


class _RefDrawsInt8(Int8Compressor):
    """The port's int8 compressor on the reference's uniform draws."""

    def draws(self, index, shape, device):
        return _ref_draws(self.seed, index, shape).to(device)


# ------------------------------------------------------------- compressors
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_topk_is_bitwise_the_reference(seed, ratio, dtype):
    """Two calls (the second with the first's error state): the sent
    gradients and the error state bitwise, ties at the threshold kept."""
    jt, pt = _trees(seed, dtype)
    ref, port = ref_comp.TopKCompressor(ratio=ratio), TopKCompressor(ratio=ratio)
    rstate = pstate = None
    for _ in range(2):
        rout, rstate = ref.compress_decompress(jt, rstate)
        pout, pstate = port.compress_decompress(pt, pstate)
        _bitwise(pout, rout)
        _bitwise(pstate, rstate)
    if ratio == 0.01:  # w0's 2,048 entries: k = 20, and the 16 tied 1.75s all kept
        assert int((pout["w0"] != 0).sum()) >= 16


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_int8_fed_the_reference_draws_is_bitwise_the_reference(seed, dtype):
    jt, pt = _trees(seed, dtype)
    ref = ref_comp.Int8Compressor(seed=seed)
    rstate, pstate = None, {k: torch.zeros(v.shape) for k, v in pt.items()}
    for _ in range(2):
        rout, rstate = ref.compress_decompress(jt, rstate)
        outs = [int8_leaf(g, e, _ref_draws(seed, i, g.shape))
                for i, (g, e) in enumerate(zip(_leaves(pt), _leaves(pstate)))]
        pout = dict(zip(sorted(pt), [o[0] for o in outs]))
        pstate = dict(zip(sorted(pt), [o[1] for o in outs]))
        _bitwise(pout, rout)
        _bitwise(pstate, rstate)
        # the compressor class routes the same draws to the same leaves
        _bitwise(_RefDrawsInt8(seed=seed).compress_decompress(pt, None)[0],
                 ref.compress_decompress(jt, None)[0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_own_draws_bounded_error_and_feedback(seed):
    """Mirror of the reference's bound: within one scale step of the input,
    and what was sent plus the error is the input."""
    _, pt = _trees(seed)
    out, err = Int8Compressor(seed=seed).compress_decompress(pt, None)
    for k, g in pt.items():
        scale = float(g.abs().max()) / 127.0
        assert float((out[k] - g).abs().max()) <= scale * 1.01
        np.testing.assert_allclose((out[k] + err[k]).numpy(), g.numpy(), atol=1e-5)


def test_int8_own_draws_are_unbiased_and_fixed_per_leaf():
    """Over 64 seeds the rounding error averages to ~0 (E[q] = g / scale);
    one compressor draws the same uniforms for a leaf on every call (the
    reference's quirk) and different ones for different leaves."""
    g = {"w": torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(
        np.float32))}
    scale = float(g["w"].abs().max()) / 127.0
    errs = [Int8Compressor(seed=s).compress_decompress(g, None)[0]["w"] - g["w"]
            for s in range(64)]
    bias = float(torch.stack(errs).mean())
    assert abs(bias) < 0.01 * scale, (bias, scale)
    comp = Int8Compressor(seed=9)
    a, b = comp.draws(0, (4096,), "cpu"), comp.draws(0, (4096,), "cpu")
    assert torch.equal(a, b) and not torch.equal(a, comp.draws(1, (4096,), "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("make", [lambda: TopKCompressor(ratio=0.05),
                                  lambda: Int8Compressor(seed=0)], ids=["topk", "int8"])
def test_error_feedback_recovers_dropped_mass(make):
    """A constant gradient: the mean of what is sent converges to it."""
    g = {"w": torch.tensor([1.0] * 5 + [0.01] * 95)}
    comp, state, total, n = make(), None, torch.zeros(100), 50
    for _ in range(n):
        out, state = comp.compress_decompress(g, state)
        total += out["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(), atol=0.01)


def test_wire_ratios():
    assert wire_bytes_ratio(TopKCompressor(ratio=0.01)) == pytest.approx(0.02)
    assert wire_bytes_ratio(Int8Compressor()) == 0.25
    assert wire_bytes_ratio(None) == 1.0
    for c in (TopKCompressor(ratio=0.01), Int8Compressor()):
        ref = {"TopKCompressor": ref_comp.TopKCompressor(ratio=0.01),
               "Int8Compressor": ref_comp.Int8Compressor()}[type(c).__name__]
        assert wire_bytes_ratio(c) == ref_comp.wire_bytes_ratio(ref)


# ------------------------------------------------------------- train step
def _pair(arch):
    return ref_config(arch, reduced=True), port_config(arch, reduced=True)


def _params(rcfg, pcfg, seed):
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(seed))
    return rp, port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp),
                                          device="cpu")


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_three_compressed_train_steps_match_reference(kind):
    """``make_train_step(compressor=...)`` of both packages on the same params
    and batches (int8 on the reference's draws): loss, ce, grad_norm, the
    params and the error-feedback state after each step, at
    ``test_three_train_steps_match_reference``'s tolerances.

    Top-k must match everywhere. An int8 code rounds stochastically at
    ``u < x - floor(x)``; where the two packages' gradients, which differ in
    their last bits, put ``x - floor(x)`` on either side of the draw, the
    code differs by one. Such an entry (its error state one scale step
    apart) is counted, must be rare (under 1e-3 of the entries), and its
    param is held to the AdamW steps it took (3 lr a step); every other
    entry is held to the tolerance."""
    rcfg, pcfg = _pair("qwen2-1.5b")
    rp, pp = _params(rcfg, pcfg, seed=3)
    rc, pc = ((ref_comp.TopKCompressor(ratio=0.1), TopKCompressor(ratio=0.1)) if kind == "topk"
              else (ref_comp.Int8Compressor(seed=4), _RefDrawsInt8(seed=4)))
    kw = dict(total_steps=20, warmup=2)
    rstep = jax.jit(ref_train_step.make_train_step(rcfg, RefAdamWConfig(lr=1e-3),
                                                   compressor=rc, **kw))
    pstep = port_train_step.make_train_step(pcfg, AdamWConfig(lr=1e-3), compressor=pc, **kw)
    rs = dict(ref_train_step.init_train_state(rcfg, rp), compress=rc.init_state(rp))
    ps = dict(port_train_step.init_train_state(pcfg, pp), compress=pc.init_state(pp))
    flipped = [np.zeros(tuple(t.shape), bool) for t in _leaves(pp)]
    lr_sum = 0.0
    for i in range(3):
        b = synthetic_batch(seed=0, step=i, batch=2, seq=24, vocab=pcfg.vocab_size,
                            family=pcfg.family, d_model=pcfg.d_model)
        rs, rm = rstep(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        lr = float(rm["lr"])
        lr_sum += lr
        assert float(pm["lr"]) == lr > 0
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), atol=ATOL, rtol=RTOL)
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        errs = list(zip(_leaves(ps["compress"]), jax.tree_util.tree_leaves(rs["compress"])))
        assert len(errs) == len(flipped)
        for f, (g, w) in zip(flipped, errs):
            # an int8 error lies within one scale step: a flipped code moves it
            # by about the largest error of its leaf
            diff = np.abs(g.numpy() - np.asarray(w))
            f |= (diff > 0.5 * np.abs(np.asarray(w)).max() if kind == "int8"
                  else ~np.isclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL))
        n_flips = sum(int(f.sum()) for f in flipped)
        assert n_flips == 0 if kind == "topk" else n_flips < 1e-3 * sum(f.size for f in flipped)
        for f, g, w in zip(flipped, _leaves(ps["params"]),
                           jax.tree_util.tree_leaves(rs["params"])):
            diff = np.abs(g.detach().numpy() - np.asarray(w))
            assert diff[~f].max(initial=0.0) <= LR_UNITS * lr
            assert diff[f].max(initial=0.0) <= 3 * lr_sum
        for f, (g, w) in zip(flipped, errs):
            np.testing.assert_allclose(g.numpy()[~f], np.asarray(w)[~f], atol=ATOL, rtol=RTOL)


def test_compressed_training_converges():
    """Mirror of the reference's: 20 steps of top-k (10%) with error
    feedback learn, and end within 0.35 nats of the uncompressed run."""
    cfg = port_config("smollm-360m", reduced=True)

    def train(compressor):
        t = TrainerConfig(steps=20, batch=4, seq=32, seed=7, log_every=1, warmup=2,
                          opt=AdamWConfig(lr=3e-3, weight_decay=0.0), compressor=compressor)
        return [r["loss"] for r in Trainer(cfg, t, device="cpu").run()["metrics"]]

    base, comp = train(None), train(TopKCompressor(ratio=0.1))
    assert np.mean(comp[-5:]) < np.mean(comp[:5])
    assert abs(np.mean(comp[-5:]) - np.mean(base[-5:])) < 0.35


# ------------------------------------------------------------ checkpoints
def _trainer(ckpt_dir=None, compressor=None, steps=6):
    cfg = port_config("smollm-360m", reduced=True)
    t = TrainerConfig(steps=steps, batch=2, seq=16, ckpt_dir=ckpt_dir, ckpt_every=3,
                      log_every=1, opt=AdamWConfig(lr=1e-3), compressor=compressor)
    return Trainer(cfg, t, device="cpu")


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_compressed_crash_and_resume_is_bitwise(tmp_path, kind):
    """The checkpoint keeps the error-feedback state: a run that crashes
    after step 3 and resumes ends bitwise the straight run, params and
    error state."""
    make = {"topk": lambda: TopKCompressor(ratio=0.05), "int8": lambda: Int8Compressor(seed=1)}
    straight = _trainer(compressor=make[kind]()).run()["state"]
    d = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected fault"):
        _trainer(d, make[kind]()).run(crash_at=3)
    resumed = _trainer(d, make[kind]()).run()["state"]
    assert sorted(resumed) == ["compress", "opt", "params", "step"]
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        assert torch.equal(a, b)
    assert any(float(e.abs().max()) > 0 for e in _leaves(resumed["compress"]))


def test_compressed_checkpoints_restore_across_packages(tmp_path):
    """A compressed run's state (params, AdamW, step, error feedback): the
    reference's checkpoint restores into the port's state and the port's
    into the reference's, equal leaf for leaf."""
    rcfg, pcfg = _pair("smollm-360m")
    rp, pp = _params(rcfg, pcfg, seed=2)
    rng = np.random.default_rng(0)
    errs = [rng.standard_normal(np.shape(x)).astype(np.float32)
            for x in jax.tree_util.tree_leaves(rp)]
    treedef = jax.tree_util.tree_structure(rp)
    rstate = dict(ref_train_step.init_train_state(rcfg, rp),
                  compress=jax.tree_util.tree_unflatten(treedef, [jnp.asarray(e) for e in errs]))
    ref_ckpt.save(rstate, str(tmp_path / "ref"), step=5)
    like = dict(port_train_step.init_train_state(pcfg, pp),
                compress=TopKCompressor().init_state(pp))
    back = ckpt.restore(str(tmp_path / "ref"), like)
    ref_leaves = jax.tree_util.tree_leaves(rstate)
    assert len(_leaves(back)) == len(ref_leaves)
    for p, r in zip(_leaves(back), ref_leaves):
        assert np.array_equal(p.numpy(), np.asarray(r))
    ckpt.save(back, str(tmp_path / "port"), step=5)
    again = ref_ckpt.restore(str(tmp_path / "port"), rstate)
    for r, p in zip(jax.tree_util.tree_leaves(again), _leaves(back)):
        assert np.array_equal(np.asarray(r), p.numpy())


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_launcher_compress_on_the_cpu(kind):
    out = port_launch.main(["--arch", "smollm-360m", "--device", "cpu", "--compress", kind,
                            "--steps", "3", "--batch", "2", "--seq", "16"])
    losses = [r["loss"] for r in out["metrics"]]
    assert len(losses) == 1 and all(math.isfinite(x) for x in losses)  # logged at the end
    state = out["state"]
    assert int(state["step"]) == 3
    errs = _leaves(state["compress"])
    assert len(errs) == len(_leaves(state["params"]))
    assert all(e.dtype == torch.float32 for e in errs)
    assert any(float(e.abs().max()) > 0 for e in errs)
