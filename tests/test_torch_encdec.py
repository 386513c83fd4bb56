"""The port's enc-dec path (SeamlessM4T-medium's backbone) against the
reference, on the CPU.

Parameters come from the reference's own init, carried over with
``models.api.params_from_numpy``; source frames and target tokens are made
with numpy from a seed. The port runs the flash kernel's plain version here
(causal in the decoder's self-attention, unmasked in the encoder and the
cross-attention). Tolerances: f32 atol 5e-4, rtol 1e-3
(tests/test_gnn_models.py:46), caches leaf by leaf at the same tolerance.

The reference's enc-dec ``model_prefill`` returns a cache whose
self-attention K/V are zeros with ``cache_len`` = the target length, so a
decode step after it attends to zero rows; the port copies that, and
decoding from ``model_init_cache`` at ``cache_len = 0`` is the path that
reproduces the teacher-forced forward.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import api as ref_api
from repro.models.lm import encdec as ref_encdec
from repro_torch.configs.base import get_config as port_config
from repro_torch.kernels import build
from repro_torch.models import api as port_api
from repro_torch.models.lm import encdec

ATOL, RTOL = 5e-4, 1e-3
ARCH = "seamless-m4t-medium"
B, SRC, TGT, MAX_LEN = 2, 12, 5, 16


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def seamless():
    rcfg, pcfg = ref_config(ARCH, reduced=True), port_config(ARCH, reduced=True)
    rp = ref_api.model_init(rcfg, jax.random.PRNGKey(2))
    pp = port_api.params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(0)
    src = rng.standard_normal((B, SRC, rcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, rcfg.vocab_size, (B, TGT)).astype(np.int32)
    rb = {"src_embeds": jnp.asarray(src), "tgt_tokens": jnp.asarray(tgt)}
    pb = {"src_embeds": torch.from_numpy(src), "tgt_tokens": torch.from_numpy(tgt)}
    return rcfg, pcfg, rp, pp, rb, pb


def _cache_leaves(cache):
    """A port cache's leaves in the reference's tree order (sorted keys)."""
    return [cache[k] for k in sorted(cache)]


def test_encode_and_forward_match_reference(seamless):
    rcfg, pcfg, rp, pp, rb, pb = seamless
    want = ref_encdec.encode(rp, rcfg, rb["src_embeds"])
    got = encdec.encode(pp, pcfg, pb["src_embeds"])
    assert tuple(got.shape) == want.shape == (B, SRC, rcfg.d_model)
    _close(got, want)
    rl, raux = ref_api.model_forward(rp, rcfg, rb)
    build.reset_launch_counts()
    pl, aux = port_api.model_forward(pp, pcfg, pb)
    assert build.launch_counts() == {}  # CPU tensors: the plain versions
    assert pl.dtype == torch.float32 and tuple(pl.shape) == rl.shape == (B, TGT, 512)
    assert float(aux) == float(raux) == 0.0
    _close(pl, rl)


def test_prefill_and_decode_after_it_match_reference(seamless):
    """The prefill's logits, every cache leaf (``cross_k``, ``cross_v``,
    ``k``, ``v``) and ``cache_len``; then two decode steps from that cache,
    which attend to its zero self-attention rows as the reference's do (and
    so part from the teacher-forced forward)."""
    rcfg, pcfg, rp, pp, rb, pb = seamless
    rl, rcache, rn = ref_api.model_prefill(rp, rcfg, rb, MAX_LEN)
    pl, pcache, pn = port_api.model_prefill(pp, pcfg, pb, MAX_LEN)
    assert pn == int(rn) == TGT
    _close(pl, rl)
    ref_leaves = jax.tree_util.tree_leaves(rcache)
    assert sorted(pcache) == ["cross_k", "cross_v", "k", "v"]
    for p, r in zip(_cache_leaves(pcache), ref_leaves):
        assert tuple(p.shape) == r.shape
        _close(p, r)
    assert not pcache["k"].any() and not pcache["v"].any()  # the reference's empty self K/V
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, 2)).astype(np.int32)
    fwd = port_api.model_forward(pp, pcfg, {
        "src_embeds": pb["src_embeds"],
        "tgt_tokens": torch.cat([pb["tgt_tokens"], torch.from_numpy(toks[:, :1])], 1)})[0]
    for i in range(2):
        tok = toks[:, i:i + 1]
        rd, rcache = ref_api.model_decode_step(rp, rcfg, {"tokens": jnp.asarray(tok)}, rcache,
                                               rn + i)
        pd, pcache = port_api.model_decode_step(pp, pcfg, {"tokens": torch.from_numpy(tok)},
                                                pcache, pn + i)
        assert tuple(pd.shape) == rd.shape == (B, 512)
        _close(pd, rd)
        for p, r in zip(_cache_leaves(pcache), jax.tree_util.tree_leaves(rcache)):
            _close(p, r)
        if i == 0:  # the reference's quirk, copied: off the forward's last position
            assert float((pd - fwd[:, -1]).abs().max()) > 0.1


def test_decode_from_init_cache_reproduces_the_forward(seamless):
    """``model_init_cache`` (zero self K/V, the encoder's cross K/V), then the
    target tokens one by one from ``cache_len = 0``: each step's logits are
    the teacher-forced forward's at that position, and the reference's."""
    rcfg, pcfg, rp, pp, rb, pb = seamless
    fwd = port_api.model_forward(pp, pcfg, pb)[0]
    rcache = ref_api.model_init_cache(rcfg, rp, rb, MAX_LEN)
    pcache = port_api.model_init_cache(pcfg, pp, pb, MAX_LEN)
    for p, r in zip(_cache_leaves(pcache), jax.tree_util.tree_leaves(rcache)):
        assert tuple(p.shape) == r.shape
        _close(p, r)
    tgt = pb["tgt_tokens"].numpy()
    for i in range(TGT):
        tok = tgt[:, i:i + 1]
        rd, rcache = ref_api.model_decode_step(rp, rcfg, {"tokens": jnp.asarray(tok)}, rcache,
                                               jnp.asarray(i, jnp.int32))
        pd, pcache = port_api.model_decode_step(pp, pcfg, {"tokens": torch.from_numpy(tok)},
                                                pcache, i)
        _close(pd, rd)
        _close(pd, fwd[:, i])


def test_prefill_checks_max_len(seamless):
    _, pcfg, _, pp, _, pb = seamless
    with pytest.raises(ValueError, match="max_len"):
        port_api.model_prefill(pp, pcfg, pb, TGT - 1)
