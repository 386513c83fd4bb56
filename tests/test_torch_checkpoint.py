"""The port's checkpoints and the Trainer's fault tolerance, on the CPU.

Ports of ``tests/test_fault_tolerance.py``'s checkpoint tests (roundtrip with
bf16 kept, retention, a ``.tmp`` dir invisible to restore, bit-exact crash
and resume, async saves), plus the on-disk layout against the reference's:
a checkpoint the reference's ``checkpoint.save`` wrote restores into the
port's state with equal arrays, and the port's manifest is the reference's.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models import api as port_api
from repro_torch.optim.adamw import AdamWConfig, _leaves
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.train_step import init_train_state


@pytest.fixture()
def small_trainer(tmp_path):
    cfg = get_config("smollm-360m", reduced=True)

    def make(ckpt_dir=None, steps=12, **kw):
        t = TrainerConfig(steps=steps, batch=2, seq=16, ckpt_dir=ckpt_dir, ckpt_every=5,
                          log_every=1, opt=AdamWConfig(lr=1e-3), **kw)
        return Trainer(cfg, t, device="cpu")

    return make, tmp_path


def _state():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.tensor([[1.5, -2.25], [3.0, 1e-3]], dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
        "list": [torch.ones(2, dtype=torch.int64), torch.zeros((1, 2), dtype=torch.float16)],
    }


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    ckpt.save(state, str(tmp_path), step=3)
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(str(tmp_path), state)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype  # bf16 survives the roundtrip as bf16
        assert torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    state = {"x": torch.zeros((2,))}
    for s in [1, 2, 3, 4]:
        ckpt.save(state, str(tmp_path), step=s, keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [3, 4]


def test_no_corrupt_checkpoint_on_partial_write(tmp_path):
    """A .tmp dir (simulated mid-crash write) must be invisible to restore."""
    state = {"x": torch.arange(4.0)}
    ckpt.save(state, str(tmp_path), step=1)
    os.makedirs(tmp_path / "step_000000002.tmp")  # crashed write
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored = ckpt.restore(str(tmp_path), state)
    assert torch.equal(restored["x"], torch.arange(4.0))


def test_restore_checks_the_state_and_finds_nothing_in_an_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(2)})
    ckpt.save({"x": torch.zeros(2)}, str(tmp_path), step=1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"x": torch.zeros(2), "y": torch.zeros(2)})


def test_crash_resume_bit_exact(small_trainer):
    """Train 12 steps straight vs crash-at-7 + resume: identical params."""
    make, tmp = small_trainer
    straight = make(steps=12).run()

    d = str(tmp / "ckpt")
    with pytest.raises(RuntimeError, match="injected fault"):
        make(ckpt_dir=d, steps=12).run(crash_at=7)
    assert ckpt.latest_step(d) == 5
    # the deterministic (seed, step) data contract makes resume exact
    resumed = make(ckpt_dir=d, steps=12).run()
    assert int(resumed["state"]["step"]) == 12
    for a, b in zip(_leaves(straight["state"]), _leaves(resumed["state"])):
        assert torch.equal(a, b)


def test_async_checkpoint(small_trainer):
    make, tmp = small_trainer
    d = str(tmp / "async")
    out = make(ckpt_dir=d, steps=10, ckpt_async=True).run()
    assert ckpt.latest_step(d) == 10
    back = ckpt.restore(d, out["state"], step=5)
    assert int(back["step"]) == 5 and int(back["opt"].step) == 5


def test_restore_puts_leaves_on_the_state_s_device_or_the_one_asked(tmp_path):
    state = _state()
    ckpt.save(state, str(tmp_path), step=1)
    like = {"a": torch.zeros((3, 4), device="meta"), "nested": state["nested"],
            "list": state["list"]}
    back = ckpt.restore(str(tmp_path), like)
    assert back["a"].device.type == "meta" and back["nested"]["b"].device.type == "cpu"
    back = ckpt.restore(str(tmp_path), like, device="cpu")
    assert all(t.device.type == "cpu" for t in _leaves(back))


def _ref_state(seed=0):
    cfg = ref_config("qwen2-1.5b", reduced=True)
    params = ref_api.model_init(cfg, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    return cfg, {"params": params, "opt": ref_adamw_init(params), "step": jnp.int32(4)}


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's ``checkpoint.save`` of a train state (bf16 params,
    f32 moments) restores into the port's state with equal arrays."""
    rcfg, rstate = _ref_state()
    rstate["opt"] = rstate["opt"]._replace(
        m=jax.tree_util.tree_map(lambda x: x + 0.5, rstate["opt"].m))
    ref_ckpt.save(rstate, str(tmp_path), step=4)
    pcfg = get_config("qwen2-1.5b", reduced=True)
    params = port_api.model_init(pcfg, torch.Generator().manual_seed(1), device="cpu")
    params = {k: v for k, v in params.items()}
    like = init_train_state(pcfg, port_api.params_to(params, "cpu"))
    like["params"] = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), like["params"])
    back = ckpt.restore(str(tmp_path), like)
    ref_leaves = jax.tree_util.tree_leaves(rstate)
    port_leaves = _leaves(back)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        r = np.asarray(r)
        if r.dtype == ml_dtypes.bfloat16:
            assert p.dtype == torch.bfloat16
            assert np.array_equal(p.view(torch.int16).numpy(), r.view(np.int16))
        else:
            assert np.array_equal(p.numpy(), r)


def test_port_checkpoint_has_the_reference_layout_and_restores_there(tmp_path):
    """Manifest paths, dtypes, shapes and files as the reference writes them;
    the reference's ``restore`` reads the port's checkpoint back equal."""
    _, rstate = _ref_state(seed=2)
    ref_ckpt.save(rstate, str(tmp_path / "ref"), step=4)
    pcfg = get_config("qwen2-1.5b", reduced=True)
    params = port_api.model_init(pcfg, torch.Generator().manual_seed(1), device="cpu")
    pstate = init_train_state(pcfg, jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                                           params))
    pstate["step"] = torch.tensor(4, dtype=torch.int32)
    ckpt.save(pstate, str(tmp_path / "port"), step=4)
    manifests = []
    for who in ("ref", "port"):
        with open(tmp_path / who / "step_000000004" / "manifest.json") as f:
            manifests.append(json.load(f))
    strip = [[{k: rec[k] for k in ("path", "file", "dtype", "shape")} for rec in m["leaves"]]
             for m in manifests]
    assert strip[0] == strip[1] and manifests[1]["step"] == 4
    back = ref_ckpt.restore(str(tmp_path / "port"), rstate)
    for r, p in zip(jax.tree_util.tree_leaves(back), _leaves(pstate)):
        r = np.asarray(r)
        if p.dtype == torch.bfloat16:
            assert r.dtype == ml_dtypes.bfloat16
            assert np.array_equal(r.view(np.int16), p.view(torch.int16).numpy())
        else:
            assert np.array_equal(r, p.numpy())
