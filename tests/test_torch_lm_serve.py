"""The port's ``ServeEngine`` against the reference's, on the CPU.

Parameters come from the reference's own init, carried over with
``params_from_numpy``; prompts are made with numpy from a seed. Greedy
generation is compared token for token (the REDUCED configs are f32, where
port and reference agree to ~1e-6 in the logits).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs.base import get_config as port_config
from repro_torch.kernels import build
from repro_torch.models import api as port_api
from repro_torch.serve.engine import ServeEngine

MAX_LEN = 48


@pytest.fixture(scope="module", params=["smollm-360m", "qwen3-8b", "mamba2-370m"])
def engines(request):
    rcfg, pcfg = ref_config(request.param, reduced=True), port_config(request.param, reduced=True)
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(0))
    pp = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return (rcfg, rp, RefServeEngine(rcfg, rp, max_len=MAX_LEN),
            pcfg, pp, ServeEngine(pcfg, pp, max_len=MAX_LEN, device="cpu"))


def _prompts(cfg, seed, b=2, p=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, p)).astype(np.int32)


def test_generate_matches_reference_token_for_token(engines):
    rcfg, _, ref, pcfg, _, port = engines
    prompts = _prompts(rcfg, 1, b=3, p=11)
    want = np.asarray(ref.generate(jnp.asarray(prompts), max_new_tokens=7))
    build.reset_launch_counts()
    got = port.generate(prompts, max_new_tokens=7)
    assert build.launch_counts() == {}  # the CPU runs the plain versions
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_stepwise_argmax(engines):
    """ServeEngine output == greedy decoding through full forwards
    (tests/test_serve.py:27-38)."""
    _, _, _, pcfg, pp, port = engines
    prompts = _prompts(pcfg, 2)
    out = port.generate(prompts, max_new_tokens=6)
    seq = torch.from_numpy(prompts).long()
    for _ in range(6):
        logits, _ = port_api.model_forward(pp, pcfg, {"tokens": seq})
        nxt = torch.argmax(logits[:, -1, : pcfg.vocab_size], -1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq.numpy())


def test_generate_deterministic(engines):
    _, _, _, pcfg, _, port = engines
    prompts = _prompts(pcfg, 3)
    assert torch.equal(port.generate(prompts, max_new_tokens=5),
                       port.generate(prompts, max_new_tokens=5))


def test_generate_respects_max_len(engines):
    _, _, _, pcfg, _, port = engines
    with pytest.raises(ValueError, match="max_len"):
        port.generate(np.zeros((1, 8), np.int32), max_new_tokens=MAX_LEN)


def test_eos_masks_finished_sequences(engines):
    """A sequence that emitted ``eos_id`` repeats it; generation stops once
    every sequence has, as the reference's does."""
    rcfg, _, ref, pcfg, _, port = engines
    prompts = _prompts(pcfg, 4, b=3)
    free = port.generate(prompts, max_new_tokens=8).numpy()
    eos = int(free[0, 8 + 2])  # sequence 0 emits it at its third new token
    got = port.generate(prompts, max_new_tokens=8, eos_id=eos).numpy()
    want = np.asarray(ref.generate(jnp.asarray(prompts), max_new_tokens=8, eos_id=eos))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 8 + 2:] == eos).all()
    every = port.generate(prompts[:1], max_new_tokens=8, eos_id=eos).numpy()
    assert every.shape == (1, 8 + 3)  # stopped when its only sequence finished


def test_int8_kv_close_to_model_dtype_cache():
    """int8 KV cache vs the model-dtype cache (tests/test_int8_kv.py:15-41):
    relative logit error < 0.05 and top-1 agreement >= 90%."""
    cfg = port_config("qwen3-8b", reduced=True)
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = port_api.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_prompts(cfg, 1, b=2, p=12)).long()

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


def test_engine_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config("qwen3-8b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, max_len=16)
    eng = ServeEngine(cfg, max_len=16, device="cpu", generator=torch.Generator().manual_seed(1))
    assert eng.device == torch.device("cpu") and eng.params["embed"].device.type == "cpu"
    again = ServeEngine(cfg, max_len=16, device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(eng.params["units"][0]["attn"]["wq"], again.params["units"][0]["attn"]["wq"])
