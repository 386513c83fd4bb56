"""The port's VLM path (Qwen2-VL's backbone: M-RoPE, ``embeds`` input)
against the reference, on the CPU.

Parameters come from the reference's own init, carried over with
``models.api.params_from_numpy``; embeddings, tokens and the image grid are
made with numpy from a seed. The port runs the flash kernel's plain version
here. Tolerances: f32 atol 5e-4, rtol 1e-3 (tests/test_gnn_models.py:46);
M-RoPE alone atol 1e-5 (the same f32 products and rotation; only sin and cos
differ in the last ulp between the two libraries).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro.models.lm import rope as ref_rope
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs.base import get_config as port_config
from repro_torch.kernels import build
from repro_torch.models import api as port_api
from repro_torch.models.lm import rope
from repro_torch.serve.engine import ServeEngine

ATOL, RTOL = 5e-4, 1e-3
ARCH = "qwen2-vl-7b"
MAX_LEN = 48


def vlm_positions(batch: int, text0: int, grid_h: int, grid_w: int, text1: int) -> np.ndarray:
    """int32[3, B, S] M-RoPE streams of a text prefix, one image of
    grid_h x grid_w patches (t fixed at the prefix's end, h and w advancing
    over the grid) and more text continuing from the largest position + 1,
    S = text0 + grid_h * grid_w + text1."""
    t = np.arange(text0)
    streams = [np.stack([t, t, t])]
    hh, ww = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    img = np.stack([np.full(grid_h * grid_w, text0), text0 + hh.ravel(), text0 + ww.ravel()])
    streams.append(img)
    start = img.max() + 1
    t1 = np.arange(start, start + text1)
    streams.append(np.stack([t1, t1, t1]))
    pos = np.concatenate(streams, axis=1).astype(np.int32)  # [3, S]
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, pos.shape[1])))


@pytest.mark.parametrize("hd,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference_on_distinct_streams(hd, sections):
    pos = vlm_positions(2, 5, 4, 6, 7)
    assert not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2])
    x = np.random.default_rng(hd).standard_normal((2, pos.shape[2], 3, hd)).astype(np.float32)
    want = np.asarray(ref_rope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # a section mix-up would show: the streams differ, so M-RoPE is not RoPE
    # on any single stream
    for stream in pos:
        plain = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(stream), 1e6)
        assert not torch.allclose(plain, got, atol=1e-3)
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (1, 1, 1))


def test_mrope_text_positions_bitwise():
    want = np.asarray(ref_rope.mrope_text_positions(3, 11))
    got = rope.mrope_text_positions(3, 11)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # text M-RoPE is RoPE
    x = torch.randn((3, 11, 2, 16), generator=torch.Generator().manual_seed(0))
    assert torch.equal(rope.apply_mrope(x, got, 1e4, (4, 2, 2)), rope.apply_rope(x, got[0], 1e4))


@pytest.fixture(scope="module")
def vlm():
    rcfg, pcfg = ref_config(ARCH, reduced=True), port_config(ARCH, reduced=True)
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(1))
    pp = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rcfg, pcfg, rp, pp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def _assert_caches_close(got, want):
    ref_leaves = jax.tree_util.tree_leaves(want)
    port_leaves = [c[k] for c in got for k in sorted(c)]
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        _close(p, r)


def _inputs(cfg, seed, embeds: bool):
    """(reference batch, port batch) of B 2: embeds [2, 35, D] with the
    image-grid positions (text 5, a 4 x 5 grid, text 10), or 35 tokens."""
    rng = np.random.default_rng(seed)
    if not embeds:
        toks = rng.integers(0, cfg.vocab_size, (2, 35)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    emb = rng.standard_normal((2, 35, cfg.d_model)).astype(np.float32)
    pos = vlm_positions(2, 5, 4, 5, 10)
    return ({"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
            {"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(pos)})


@pytest.mark.parametrize("embeds", [True, False], ids=["embeds", "tokens"])
def test_vlm_forward_prefill_decode_match_reference(vlm, embeds):
    """forward, prefill (logits, every cache leaf, cache_len), then one
    decode step on tokens and one on embeds [B, 1, D] (M-RoPE at cache_len
    on all three streams, as in the reference)."""
    rcfg, pcfg, rp, pp = vlm
    rb, pb = _inputs(rcfg, 3, embeds)
    rl, _ = ref_api.model_forward(rp, rcfg, rb)
    pl, aux = port_api.model_forward(pp, pcfg, pb)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == rl.shape and float(aux) == 0.0
    _close(pl, rl)
    rl, rcache, rn = ref_api.model_prefill(rp, rcfg, rb, MAX_LEN)
    pl, pcache, pn = port_api.model_prefill(pp, pcfg, pb, MAX_LEN)
    assert pn == int(rn) == 35
    _close(pl, rl)
    _assert_caches_close(pcache, rcache)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, rcfg.vocab_size, (2, 1)).astype(np.int32)
    emb = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    steps = [({"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}),
             ({"embeds": jnp.asarray(emb)}, {"embeds": torch.from_numpy(emb)})]
    for i, (rstep, pstep) in enumerate(steps):
        rd, rcache = ref_api.model_decode_step(rp, rcfg, rstep, rcache, rn + i)
        pd, pcache = port_api.model_decode_step(pp, pcfg, pstep, pcache, pn + i)
        assert tuple(pd.shape) == rd.shape
        _close(pd, rd)
        _assert_caches_close(pcache, rcache)


def test_vlm_init_cache_takes_embeds_batch(vlm):
    rcfg, pcfg, rp, pp = vlm
    rb, pb = _inputs(rcfg, 5, True)
    want = ref_api.model_init_cache(rcfg, rp, rb, MAX_LEN)
    got = port_api.model_init_cache(pcfg, pp, pb, MAX_LEN)
    assert [tuple(t.shape) for c in got for t in (c[k] for k in sorted(c))] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]


def test_vlm_generate_matches_reference_token_for_token(vlm):
    """``ServeEngine.generate`` takes token prompts (text M-RoPE), as the
    reference's does."""
    rcfg, pcfg, rp, pp = vlm
    prompts = np.random.default_rng(6).integers(0, rcfg.vocab_size, (3, 9)).astype(np.int32)
    want = np.asarray(RefServeEngine(rcfg, rp, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), max_new_tokens=7))
    build.reset_launch_counts()
    got = ServeEngine(pcfg, pp, max_len=MAX_LEN, device="cpu").generate(prompts,
                                                                         max_new_tokens=7)
    assert build.launch_counts() == {}  # the CPU runs the plain versions
    np.testing.assert_array_equal(got.numpy(), want)
