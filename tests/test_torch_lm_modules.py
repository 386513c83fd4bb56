"""The port's LM layers against the reference's, on the CPU: norms, RoPE,
MLPs, attention (prefill with ``return_kv``, decode over bf16 and int8
caches) and the Mamba2 mixer (chunked prefill with its state, decode).

Parameters come from the reference's own init functions and are carried
over leaf by leaf; inputs are made with numpy from a seed. The port runs its
kernels' plain versions here. Tolerance: atol 5e-4, rtol 1e-3
(tests/test_gnn_models.py:46) unless a test states another.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import attention as ref_attn
from repro.models.lm import mamba as ref_mamba
from repro.models.lm import mlp as ref_mlp
from repro.models.lm import norm as ref_norm
from repro.models.lm import rope as ref_rope
from repro_torch.kernels import build
from repro_torch.models import api as port_api
from repro_torch.models.lm import attention as port_attn
from repro_torch.models.lm import mamba as port_mamba
from repro_torch.models.lm import mlp as port_mlp
from repro_torch.models.lm import norm as port_norm
from repro_torch.models.lm import rope as port_rope

ATOL, RTOL = 5e-4, 1e-3

# The reference's layers, compiled once per shape (eager JAX dispatch would
# compile each op of the layer separately, several times slower here).
_MAMBA_STATIC = ("d_inner", "ssm_state", "heads", "headdim", "chunk", "norm_eps", "return_state")
ref_attention = jax.jit(ref_attn.attention, static_argnums=(2,), static_argnames=("return_kv",))
ref_decode_attention = jax.jit(ref_attn.decode_attention, static_argnums=(2,))
ref_mamba_apply = jax.jit(ref_mamba.mamba_apply, static_argnames=_MAMBA_STATIC)
ref_mamba_decode = jax.jit(ref_mamba.mamba_decode, static_argnames=_MAMBA_STATIC[:4] + ("norm_eps",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_norms_match_reference():
    x = _x((2, 5, 24)) * 3 + 1
    rs = {"scale": _x((24,), 1)}
    ls = {"scale": _x((24,), 2), "bias": _x((24,), 3)}
    t = {k: torch.from_numpy(v) for k, v in rs.items()}
    _close(port_norm.rmsnorm(t, torch.from_numpy(x), eps=1e-5),
           ref_norm.rmsnorm(rs, jnp.asarray(x), eps=1e-5))
    t = {k: torch.from_numpy(v) for k, v in ls.items()}
    _close(port_norm.layernorm(t, torch.from_numpy(x)), ref_norm.layernorm(ls, jnp.asarray(x)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert port_norm.rmsnorm({"scale": torch.ones(24)}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (20, 1e6), (128, 1e6)])
def test_rope_matches_reference(hd, theta):
    x = _x((2, 7, 3, hd))
    pos = np.random.default_rng(1).integers(0, 4000, (2, 7))
    _close(port_rope.rope_frequencies(hd, theta), ref_rope.rope_frequencies(hd, theta),
           atol=0, rtol=1e-6)
    _close(port_rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_mlp_matches_reference(kind, bias):
    rp = ref_mlp.mlp_init(jax.random.PRNGKey(2), 24, 40, kind, bias=bias, dtype=jnp.float32)
    rp = {k: v + 0.1 if k.startswith("b") else v for k, v in rp.items()}  # nonzero biases
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = _x((2, 5, 24))
    _close(port_mlp.mlp_apply(pp, torch.from_numpy(x), kind),
           ref_mlp.mlp_apply(rp, jnp.asarray(x), kind))


def _attn_params(d, h, kv, hd, *, qkv_bias, qk_norm, dtype=jnp.float32, seed=4):
    rp = ref_attn.attn_init(jax.random.PRNGKey(seed), d, h, kv, hd, qkv_bias=qkv_bias,
                            qk_norm=qk_norm, dtype=dtype)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in rp:  # nonzero biases, so they are exercised
            rp[name] = jnp.asarray(rng.standard_normal(rp[name].shape) * 0.1, dtype)
    return rp, port_api._tree(_np(rp), lambda a: port_api._leaf(a, torch.device("cpu")))


@pytest.mark.parametrize("h,kv,hd,qkv_bias,qk_norm", [
    (4, 2, 16, False, True), (3, 1, 20, True, False), (6, 2, 16, True, True),
])
def test_attention_return_kv_matches_reference(h, kv, hd, qkv_bias, qk_norm):
    d, s = 48, 37
    rp, pp = _attn_params(d, h, kv, hd, qkv_bias=qkv_bias, qk_norm=qk_norm)
    rst = ref_attn.AttnStatics(h, kv, hd, rope_theta=1e6, qk_norm=qk_norm)
    pst = port_attn.AttnStatics(h, kv, hd, rope_theta=1e6, qk_norm=qk_norm)
    x = _x((2, s, d))
    pos = np.broadcast_to(np.arange(s), (2, s))
    rout, rk, rv = ref_attention(rp, jnp.asarray(x), rst, jnp.asarray(pos), return_kv=True)
    build.reset_launch_counts()
    pout, pk, pv = port_attn.attention(pp, torch.from_numpy(x), pst, torch.from_numpy(pos.copy()),
                                       return_kv=True)
    assert build.launch_counts() == {}
    for got, want in ((pout, rout), (pk, rk), (pv, rv)):
        _close(got, want)


@pytest.mark.parametrize("cache", ["model", "int8"])
def test_decode_attention_matches_reference(cache):
    """bf16 model: the bf16 cache, or the int8 cache with f32 scales. Both
    sides round the same bf16 values; agreement within 3e-2 (a few bf16 ulps
    of the outputs at magnitude ~1, from other accumulation orders)."""
    d, h, kv, hd, b, l, n = 48, 4, 2, 16, 2, 12, 7
    rp, pp = _attn_params(d, h, kv, hd, qkv_bias=False, qk_norm=True, dtype=jnp.bfloat16)
    rst = ref_attn.AttnStatics(h, kv, hd, qk_norm=True)
    pst = port_attn.AttnStatics(h, kv, hd, qk_norm=True)
    rng = np.random.default_rng(5)
    k = rng.standard_normal((b, l, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, l, kv, hd)).astype(np.float32)
    k[:, n:] = v[:, n:] = 0.0
    x = jnp.asarray(_x((b, 1, d), 6), jnp.bfloat16)
    xt = port_api._leaf(np.asarray(x), torch.device("cpu"))
    if cache == "int8":
        kq, ks = ref_attn.quantize_kv(jnp.asarray(k))
        vq, vs = ref_attn.quantize_kv(jnp.asarray(v))
        pkq, pks = port_attn.quantize_kv(torch.from_numpy(k))
        assert np.array_equal(pkq.numpy(), np.asarray(kq))
        _close(pks, ks, atol=0, rtol=1e-6)
        rargs = (kq, vq, jnp.asarray(n, jnp.int32), ks, vs)
        pargs = [torch.from_numpy(np.array(a)) for a in (kq, vq)] + [n] + [
            torch.from_numpy(np.array(a)) for a in (ks, vs)]
    else:
        kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        rargs = (kb, vb, jnp.asarray(n, jnp.int32))
        pargs = [port_api._leaf(np.asarray(a), torch.device("cpu")) for a in (kb, vb)] + [n]
    rres = ref_decode_attention(rp, x, rst, *rargs)
    pres = port_attn.decode_attention(pp, xt, pst, *pargs)
    assert pres[1] is pargs[0]  # the caches are written in place
    _close(pres[0], rres[0], atol=3e-2, rtol=0)
    for got, want in zip(pres[1:], rres[1:]):
        if want.dtype == jnp.int8:
            assert np.abs(got.numpy().astype(int) - np.asarray(want, int)).max() <= 1
        else:
            _close(got, want, atol=1e-6, rtol=1e-6)


def _mamba_pair(d=32, n=8, headdim=8, seed=7):
    di, h = 2 * d, (2 * d) // headdim
    rp = ref_mamba.mamba_init(jax.random.PRNGKey(seed), d, d_inner=di, ssm_state=n, heads=h,
                              dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    rp["A_log"] = jnp.asarray(rng.uniform(-1, 1, h), jnp.float32)  # decays differ per head
    rp["conv_x"]["b"] = jnp.asarray(rng.standard_normal(di) * 0.1, jnp.float32)
    pp = port_api._tree(_np(rp), lambda a: port_api._leaf(a, torch.device("cpu")))
    return rp, pp, dict(d_inner=di, ssm_state=n, heads=h, headdim=headdim)


@pytest.mark.parametrize("l,chunk", [(37, 16), (48, 16), (2, 16), (3, 256), (20, 256)])
def test_mamba_apply_return_state_matches_reference(l, chunk):
    """L not a multiple of the chunk (padded steps), L < K - 1 (the conv
    tail is front-padded), one chunk shorter than ``chunk``."""
    rp, pp, kw = _mamba_pair()
    x = _x((2, l, 32), l)
    rout, rstate = ref_mamba_apply(rp, jnp.asarray(x), chunk=chunk, return_state=True, **kw)
    pout, pstate = port_mamba.mamba_apply(pp, torch.from_numpy(x), chunk=chunk,
                                          return_state=True, **kw)
    _close(pout, rout)
    assert sorted(pstate) == sorted(rstate)
    for key in rstate:
        assert tuple(pstate[key].shape) == rstate[key].shape
        _close(pstate[key], rstate[key])


def test_mamba_decode_matches_reference():
    rp, pp, kw = _mamba_pair(seed=8)
    x = _x((2, 9, 32), 9)
    _, rstate = ref_mamba_apply(rp, jnp.asarray(x), chunk=4, return_state=True, **kw)
    _, pstate = port_mamba.mamba_apply(pp, torch.from_numpy(x), chunk=4, return_state=True, **kw)
    for step in range(3):
        xt = _x((2, 1, 32), 20 + step)
        rout, rstate = ref_mamba_decode(rp, jnp.asarray(xt), rstate, **kw)
        pout, pstate = port_mamba.mamba_decode(pp, torch.from_numpy(xt), pstate, **kw)
        _close(pout, rout)
        for key in rstate:
            _close(pstate[key], rstate[key])


def test_mamba_state_init_builds_on_the_device_asked_for():
    """The decode state on the device the caller names (no default: the port
    runs on the card unless asked for the CPU), the reference's leaves."""
    kw = dict(d_inner=64, ssm_state=8, heads=8, headdim=8, conv=4)
    with pytest.raises(TypeError, match="device"):
        port_mamba.mamba_state_init(2, **kw)
    got = port_mamba.mamba_state_init(2, device="cpu", **kw)
    want = ref_mamba.mamba_state_init(2, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].device.type == "cpu" and got[key].dtype == torch.float32
        assert tuple(got[key].shape) == want[key].shape and not got[key].any()
