"""The LM kernels' plain versions against the reference's Pallas kernels, on the CPU.

The same numpy inputs (from a seed) go through the reference's kernels in
interpret mode and its oracles, and through the port's wrappers, which run
the plain versions (``ref.py``) on CPU tensors; ``test_torch_kernels_gpu.py``
holds the CUDA kernels against those plain versions on the card.

Tolerances: atol 1e-4, rtol 1e-4 in f32 (tests/test_kernels_ssd.py:27; the
sums run in another order). The SSD kernel keeps f32 on the TF32 tensor
cores by splitting each operand in two TF32 terms; ``_split_tf32_ssd``
emulates that arithmetic here. With bf16 inputs both sides keep scores and
probabilities in f32 and round only the output to bf16, so they agree within
1.6e-2: two bf16 ulps at magnitude 1.

Flash's backward: the plain version ``flash_attention_bwd_ref`` (the
explicit formulas from the forward's output and log-sum-exp) and the
wrapper's autograd Function on CPU tensors against torch autograd through
``flash_attention_ref`` and ``jax.grad`` of the reference's ``chunked`` and
``xla`` attentions, and ``flash_attention_lse_ref`` against JAX's
``logsumexp``, at the same f32 tolerance.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan import ops as ref_ssd
from repro.models.lm import attention as ref_attn
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.kernels.ssd_scan import ops as ssd_ops

ATOL = RTOL = 1e-4
BF16_ATOL = 1.6e-2


def _qkv(b, s, t, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    return q, k, v


# (hd, S, H, KV): head dims 16/20/64, S ragged against the 128 block of the
# TPU kernel (and the 64 block of the CUDA kernel), H/KV of 1, 3 and 2.
@pytest.mark.parametrize("hd,s,h,kv", [
    (16, 16, 2, 2),
    (20, 200, 3, 1),
    (64, 300, 4, 2),
    (16, 300, 6, 2),
    (64, 16, 3, 1),
    (20, 200, 2, 1),
])
def test_flash_plain_matches_reference_pallas_and_ref(hd, s, h, kv):
    q, k, v = _qkv(2, s, s, h, kv, hd, seed=hd * s + h)
    want_pallas = np.asarray(ref_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want_ref = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, h, hd)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=RTOL)


def test_flash_plain_aligns_causality_to_the_sequence_ends():
    """S < T (a prompt continued over a longer K/V): row i sees keys up to
    i + T - S, as in the TPU kernel."""
    q, k, v = _qkv(1, 40, 100, 4, 2, 16, seed=5)
    want = np.asarray(ref_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_flash_plain_keeps_probabilities_f32_like_the_tpu_kernel():
    """bf16 inputs: the plain version, like the Pallas kernel, widens q, k, v,
    keeps p in f32 for P.V and rounds only the output."""
    q, k, v = _qkv(2, 130, 130, 4, 2, 64, seed=7)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_fa.flash_attention(qb, kb, vb).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert np.array_equal(tq.float().numpy(), np.asarray(qb.astype(jnp.float32)))  # same rounding
    got = fa_ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


# Non-causal (the TPU kernel's causal=False branch: an encoder, S = T, and
# cross-attention, any S and T): (hd, S, T, H, KV) with S < T, S = T, S > T,
# S = 1 (a decode step's cross-attention), T ragged against the 128 block of
# the TPU kernel and the 64 block of the CUDA kernels, GQA groups 1 and 7
# (Qwen2-VL's 28 heads over 4).
NONCAUSAL = [
    (16, 36, 100, 4, 4),
    (16, 64, 64, 7, 1),
    (20, 100, 37, 14, 2),
    (16, 1, 100, 4, 4),
    (64, 30, 201, 7, 1),
    (16, 130, 130, 2, 2),
]


@pytest.mark.parametrize("hd,s,t,h,kv", NONCAUSAL)
def test_flash_plain_noncausal_matches_reference_pallas_and_ref(hd, s, t, h, kv):
    q, k, v = _qkv(2, s, t, h, kv, hd, seed=hd + s + t + h)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_pallas = np.asarray(ref_fa.flash_attention(jq, jk, jv, causal=False, interpret=True))
    want_ref = np.asarray(attention_ref(jq, jk, jv, causal=False))
    build.reset_launch_counts()
    got = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=False)
    assert build.launch_counts() == {}
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, h, hd)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=RTOL)
    # every key is seen: not the causal function where that one masks a key
    # (S = 1 sees every key under the end-aligned causal mask too)
    if 1 < s <= t:
        causal = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v))
        assert not torch.allclose(causal, got, atol=ATOL)


@pytest.mark.parametrize("hd,s,t,h,kv", [(64, 36, 130, 7, 1), (64, 130, 130, 4, 4),
                                         (64, 1, 70, 4, 2)])
def test_flash_plain_noncausal_bf16_matches_reference_pallas(hd, s, t, h, kv):
    """bf16, unmasked: the plain version and the Pallas kernel both keep p in
    f32 and round only the output (two bf16 ulps at magnitude 1)."""
    q, k, v = _qkv(2, s, t, h, kv, hd, seed=s + t)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_fa.flash_attention(qb, kb, vb, causal=False, interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa_ops.flash_attention(tq, tk, tv, causal=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


def test_flash_wrapper_checks_shapes_and_runs_plain_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 16, seed=0))
    build.reset_launch_counts()
    out = fa_ops.flash_attention(q, k, v)
    assert build.launch_counts() == {}  # CPU tensors: no kernel launch
    assert torch.equal(out, flash_attention_ref(q, k, v))
    with pytest.raises(ValueError, match="S <= T"):
        fa_ops.flash_attention(q, k[:, :5], v[:, :5])
    # unmasked, S > T is valid (cross-attention over a shorter source)
    assert torch.equal(fa_ops.flash_attention(q, k[:, :5], v[:, :5], causal=False),
                       flash_attention_ref(q, k[:, :5], v[:, :5], causal=False))
    with pytest.raises(ValueError, match="T >= 1"):
        fa_ops.flash_attention(q, k[:, :0], v[:, :0], causal=False)
    with pytest.raises(ValueError, match="does not match"):
        fa_ops.flash_attention(q[..., :3, :], k, v)  # 3 q-heads over 2 kv-heads
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v[..., :8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 100, 128])
def test_flash_variant_follows_dtype_and_head_dim(dtype, hd):
    """bf16 with hd 64 or 128 (every served LM) takes the tensor-core kernel;
    f32 (the REDUCED configs) and any other head dim the CUDA-core kernel."""
    want = "tensor_cores" if dtype == torch.bfloat16 and hd in (64, 128) else "cuda_cores"
    assert fa_ops.flash_variant(dtype, hd) == want
    assert fa_ops.flash_variant(dtype, hd, aligned=False) == "cuda_cores"


# ---------------------------------------------------------- the backward
# (hd, S, T, H, KV, causal): causal S = T and S < T (end-aligned), unmasked
# S < T, S > T and S = 1 (cross-attention), GQA groups 1, 3 and 7, T ragged
# against the kernels' 64-key blocks.
BWD_CASES = [
    (16, 40, 40, 4, 2, True),
    (20, 70, 130, 3, 1, True),
    (16, 36, 100, 4, 4, False),
    (20, 100, 37, 14, 2, False),
    (16, 1, 65, 4, 4, False),
    (64, 65, 65, 7, 1, True),
]


def _qkvd(b, s, t, h, kv, hd, seed):
    """q, k, v and an upstream gradient dO."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, t, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, h, hd)).astype(np.float32))


def _jax_attn_grads(q, k, v, do, causal, impl):
    b, s, h, hd = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(hd)

    def f(q_, k_, v_):
        qg = q_.reshape(b, s, kv, h // kv, hd)
        if impl == "chunked":
            out = ref_attn._sdpa_chunked(qg, k_, v_, causal=causal, scale=scale, chunk=32)
        else:
            out = ref_attn._sdpa_xla(qg, k_, v_, causal=causal, scale=scale)
        return out.reshape(b, s, h, hd)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("hd,s,t,h,kv,causal", BWD_CASES)
def test_flash_bwd_plain_matches_autograd_and_jax(hd, s, t, h, kv, causal):
    q, k, v, do = _qkvd(2, s, t, h, kv, hd, seed=hd + s + t)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, causal=causal)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    o, lse = flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    got = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)), o, lse,
                                  torch.from_numpy(do), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)
    for impl in ("chunked", "xla"):
        for g, w in zip(got, _jax_attn_grads(q, k, v, do, causal, impl)):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hd,s,t,h,kv,causal", BWD_CASES[:4])
def test_flash_lse_plain_matches_jax_logsumexp(hd, s, t, h, kv, causal):
    q, k, v = _qkv(1, s, t, h, kv, hd, seed=s * t)
    scores = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q),
                        jnp.repeat(jnp.asarray(k), h // kv, axis=2)) / math.sqrt(hd)
    if causal:
        mask = jnp.arange(t)[None, :] - (t - s) > jnp.arange(s)[:, None]
        scores = jnp.where(mask, -1e30, scores)
    want = np.asarray(jax.scipy.special.logsumexp(scores, axis=-1))
    out, lse = flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, h, s)
    np.testing.assert_allclose(lse.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(out, flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                                causal=causal))


@pytest.mark.parametrize("hd,s,t,h,kv,causal", BWD_CASES[:3])
def test_flash_wrapper_under_grad_runs_the_plain_backward_on_cpu(hd, s, t, h, kv, causal):
    """On CPU tensors that require grad the wrapper's autograd Function runs
    the plain forward and the plain backward, and launches nothing."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkvd(1, s, t, h, kv, hd, seed=7))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    build.reset_launch_counts()
    out = fa_ops.flash_attention(*leaves, causal=causal)
    assert out.grad_fn is not None and torch.equal(out.detach(), flash_attention_ref(
        q, k, v, causal=causal))
    got = torch.autograd.grad(out, leaves, do)
    assert build.launch_counts() == {}
    o, lse = flash_attention_lse_ref(q, k, v, causal=causal)
    for g, w in zip(got, flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)):
        assert torch.equal(g, w)
    # only some inputs require grad (cross-attention's K/V from a frozen encoder)
    qg = q.clone().requires_grad_()
    (dq,) = torch.autograd.grad(fa_ops.flash_attention(qg, k, v, causal=causal), (qg,), do)
    assert torch.equal(dq, got[0])
    with torch.no_grad():  # no grad mode: the plain forward, no graph
        assert fa_ops.flash_attention(*leaves, causal=causal).grad_fn is None


def test_flash_bwd_wrapper_checks_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _qkvd(1, 8, 8, 4, 2, 16, seed=0))
    o, lse = flash_attention_lse_ref(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa_ops.flash_attention_bwd(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError, match="S <= T"):
        fa_ops.flash_attention_bwd(q, k[:, :5], v[:, :5], o, lse, do)


@pytest.mark.parametrize("dtype,hd,aligned,want", [
    (torch.bfloat16, 128, True, "tensor_cores"), (torch.bfloat16, 64, True, "tensor_cores"),
    (torch.bfloat16, 128, False, "cuda_cores"), (torch.bfloat16, 20, True, "cuda_cores"),
    (torch.bfloat16, 32, True, "cuda_cores"), (torch.float32, 128, True, "cuda_cores"),
    (torch.float32, 64, True, "cuda_cores"),
])
def test_flash_bwd_variant_follows_the_forwards_rule(dtype, hd, aligned, want):
    """The backward takes the tensor-core pair exactly where the forward takes
    its tensor-core kernel (bf16, hd 64 or 128) and every one of q, k, v,
    out, dout and the three gradients starts on a 16-byte boundary; a single
    base off it sends the call to the CUDA-core pair."""
    shape = (1, 70, 4, hd)
    tensors = [torch.zeros(shape, dtype=dtype) for _ in range(8)]
    if not aligned:
        flat = torch.zeros(math.prod(shape) + 1, dtype=dtype)
        tensors[4] = flat[1:].view(shape)  # dout one element past a boundary
        assert tensors[4].is_contiguous() and tensors[4].data_ptr() % 16 != 0
    assert all(x.data_ptr() % 16 == 0 for i, x in enumerate(tensors) if aligned or i != 4)
    assert fa_ops.bwd_variant(*tensors) == want
    assert want == fa_ops.flash_variant(dtype, hd, aligned)


@pytest.mark.parametrize("b,t,kv,g,sms,want", [
    (4, 2048, 2, 6, 132, 2),  # Qwen2-1.5B: 256 key blocks, 512 blocks with 2 splits
    (4, 2048, 5, 3, 132, 1),  # SmolLM-360M: 640 blocks fill the card unsplit
    (2, 256, 2, 6, 132, 6),  # few key blocks: every q-head its own block
    (4, 2048, 8, 1, 132, 1),  # no GQA: nothing to split
    (1, 1024, 4, 7, 132, 7),  # Qwen2-VL's group of 7 (prime): all or nothing
    (4, 2048, 2, 6, 16, 1),  # a small card
])
def test_flash_bwd_head_splits(b, t, kv, g, sms, want):
    """The tensor-core dK/dV kernel's split of each kv-head's G q-heads:
    the fewest divisors of G that give BWD_MIN_WAVES blocks per SM."""
    splits = fa_ops.bwd_head_splits(b, t, kv, g, sms)
    assert splits == want and g % splits == 0
    blocks = kv * b * -(-t // 64)
    assert splits == g or blocks * splits >= fa_ops.BWD_MIN_WAVES * sms


def _bf16_terms(x, terms):
    """x as the sum of ``terms`` bf16 terms (hi = bf16(x), lo = bf16(x - hi), ...)."""
    out, rest = [], x
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _split_bwd(q, k, v, out, lse, dout, *, causal, terms=2):
    """The tensor-core backward's arithmetic, emulated on the CPU in f32 (not
    rounded to bf16): bf16 q, k, v, out and dO; S = Q K^T and dP = dO V^T in
    f32 (each bf16 product exact); P = exp(s * scale - lse), 0 where the
    forward masked; D = rowsum(dO o O); dS = P o (dP - D); P and dS split
    into ``terms`` bf16 terms, each a bf16 operand of its product, the
    products summed in f32: dV = P^T dO, dQ = scale dS K, dK = scale dS^T Q,
    dK and dV summed over the q-heads of each kv-head."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, s, kv, g, hd)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, s, kv, g, hd)
    sc = torch.einsum("bskgh,btkh->bkgst", qf, kf) * scale
    p = torch.exp(sc - lse.reshape(b, kv, g, s, 1))
    if causal:
        qpos = torch.arange(s)[:, None]
        kpos = torch.arange(t)[None, :]
        p = p.masked_fill((kpos - (t - s)) > qpos, 0.0)
    d = (do * out.float().reshape(b, s, kv, g, hd)).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bskgh,btkh->bkgst", do, vf)
    ds = p * (dp - d[..., None])
    dv = sum(torch.einsum("bkgst,bskgh->btkh", x, do) for x in _bf16_terms(p, terms))
    dq = sum(torch.einsum("bkgst,btkh->bskgh", x, kf) for x in _bf16_terms(ds, terms)) * scale
    dk = sum(torch.einsum("bkgst,bskgh->btkh", x, qf) for x in _bf16_terms(ds, terms)) * scale
    return dq.reshape(b, s, h, hd), dk, dv


# BWD_CASES in bf16, and Qwen2-1.5B's GQA 12/2 at hd 128 (causal) and
# Qwen2-VL's 28/4 (unmasked, S > T), cut in length.
@pytest.mark.parametrize("hd,s,t,h,kv,causal", BWD_CASES + [(128, 130, 130, 12, 2, True),
                                                             (128, 100, 70, 28, 4, False)])
def test_split_operands_keep_the_backwards_f32_function(hd, s, t, h, kv, causal):
    """P and dS as two bf16 terms each (the tensor-core backward's operands)
    keep the f32 function: before the output's rounding within 2^-15 of each
    gradient's largest magnitude (~2^-18 here; one bf16 term: ~2^-9),
    and rounded to bf16 within the 2^-7 share that the card tests and
    chip_smoke.py gate the kernels at, against ``flash_attention_bwd_ref``."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkvd(2, s, t, h, kv, hd, seed=hd + s + t))
    out, lse = flash_attention_lse_ref(q, k, v, causal=causal)
    want_f32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       do.float(), causal=causal)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    two = _split_bwd(q, k, v, out, lse, do, causal=causal)
    one = _split_bwd(q, k, v, out, lse, do, causal=causal, terms=1)
    for got, single, w32, w in zip(two, one, want_f32, want):
        top = float(w32.abs().max())
        err2 = float((got - w32).abs().max()) / top
        err1 = float((single - w32).abs().max()) / top
        assert err2 <= 2.0 ** -15, err2
        assert err1 > 16 * err2, (err1, err2)
        rounded = got.to(torch.bfloat16).float()
        assert float((rounded - w.float()).abs().max()) <= 2.0 ** -7 * float(w.float().abs().max())


def _split_p_flash(q, k, v, *, terms=2, block=64):
    """The tensor-core kernel's arithmetic, emulated on the CPU in f32: bf16
    q, k, v; S = Q.K^T in f32 (each bf16 product exact); an online softmax
    over KV blocks of ``block`` keys with f32 m and l; p split into ``terms``
    bf16 terms (p_hi, p - p_hi, ...); each block's P.V from zero, folded
    into the output as o * corr + pv; the output rounded once to bf16."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, kv, h // kv, hd)
    kf, vf = k.float(), v.float()
    qpos = torch.arange(s)[:, None]
    m = torch.full((b, kv, h // kv, s), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (hd,))
    for k0 in range(0, t, block):
        kb, vb = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        sc = torch.einsum("bskgh,btkh->bkgst", qf, kb) * (1.0 / np.sqrt(hd))
        kpos = torch.arange(k0, k0 + kb.shape[1])[None, :]
        sc = sc.masked_fill(kpos - (t - s) > qpos, float("-inf"))
        mn = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - mn)
        p = torch.exp(sc - mn[..., None])
        l = l * corr + p.sum(-1)
        pv, rest = 0.0, p
        for _ in range(terms):
            term = rest.to(torch.bfloat16).float()
            pv = pv + torch.einsum("bkgst,btkh->bkgsh", term, vb)
            rest = rest - term
        acc = acc * corr[..., None] + pv
        m = mn
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(torch.bfloat16)


@pytest.mark.parametrize("s,t,h,kv,hd", [(130, 130, 4, 2, 64), (70, 200, 2, 1, 128)])
def test_split_p_keeps_the_tpu_kernels_bf16_function(s, t, h, kv, hd):
    """Two bf16 terms of p keep the f32-p function: within the bf16 tolerance
    of the reference's Pallas kernel (interpret), and >= 99% of the bf16
    entries bitwise equal to the plain version's, the share the card tests
    ask of the kernel. One bf16 term falls below that share."""
    q, k, v = _qkv(2, s, t, h, kv, hd, seed=s + hd)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_fa.flash_attention(qb, kb, vb).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    plain = flash_attention_ref(tq, tk, tv)
    got = _split_p_flash(tq, tk, tv)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)
    assert float((got == plain).float().mean()) >= 0.99
    one = _split_p_flash(tq, tk, tv, terms=1)
    assert float((one == plain).float().mean()) < 0.99


def _ssd_inputs(b, nc, q, n, h, p, seed, decay=1.0):
    rng = np.random.default_rng(seed)
    cc = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    bc = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    xdt = rng.standard_normal((b, nc, h, q, p)).astype(np.float32)
    # a realistic decreasing log-decay (negative cumsum)
    acum = -np.cumsum(rng.uniform(size=(b, nc, h, q)) * decay, axis=-1).astype(np.float32)
    return cc, bc, xdt, acum


@pytest.mark.parametrize("b,nc,q,n,h,p", [
    (1, 2, 16, 8, 2, 8),
    (2, 3, 32, 16, 4, 16),
    (1, 1, 64, 32, 1, 32),
])
def test_ssd_plain_matches_reference_pallas_and_ref(b, nc, q, n, h, p):
    arrs = _ssd_inputs(b, nc, q, n, h, p, seed=q * h)
    want_pallas = np.asarray(ref_ssd.ssd_intra_chunk(*map(jnp.asarray, arrs)))
    want_ref = np.asarray(ssd_intra_chunk_ref(*map(jnp.asarray, arrs)))
    build.reset_launch_counts()
    got = ssd_ops.ssd_intra_chunk(*map(torch.from_numpy, arrs))
    assert build.launch_counts() == {}
    assert tuple(got.shape) == (b, nc, h, q, p)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=RTOL)


def test_ssd_wrapper_checks_shapes():
    cc, bc, xdt, acum = map(torch.from_numpy, _ssd_inputs(1, 2, 16, 8, 2, 8, seed=0))
    with pytest.raises(ValueError, match="xdt"):
        ssd_ops.ssd_intra_chunk(cc, bc, xdt[..., :4, :], acum)
    with pytest.raises(ValueError, match="acum"):
        ssd_ops.ssd_intra_chunk(cc, bc, xdt, acum[..., :1, :])


def _tf32(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest at
    mantissa bit 13, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32_ssd(cc, bc, xdt, acum, *, terms=3, step=8):
    """The SSD kernel's arithmetic, emulated on the CPU in f32. Every operand
    x of a product is split into hi = tf32(x) and lo = tf32(x - hi); each
    step of ``step`` along the summed axis forms lo·hi' + hi·lo' + hi·hi' in
    that order in a fresh sum and adds it to the running sum (``terms=1``:
    hi·hi' alone). C Bᵀ sums over the state in steps of 8; then per key step
    of 8, Y += W·Xdt with W = C Bᵀ ∘ exp(a_i − a_j), masked to i ≥ j."""
    b, nc, q, n = cc.shape

    def add(acc, eq, a, w):
        ah, bh = _tf32(a), _tf32(w)
        if terms == 1:
            return acc + torch.einsum(eq, ah, bh)
        al, bl = _tf32(a - ah), _tf32(w - bh)
        part = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
        return acc + (part + torch.einsum(eq, ah, bh))

    cb = torch.zeros((b, nc, q, q))
    for n0 in range(0, n, step):
        cb = add(cb, "bcin,bcjn->bcij", cc[..., n0:n0 + step], bc[..., n0:n0 + step])
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    w = torch.where(causal, cb[:, :, None] * torch.exp(acum[..., :, None] - acum[..., None, :]),
                    torch.zeros(()))
    y = torch.zeros(xdt.shape)
    for j0 in range(0, q, step):
        y = add(y, "bchij,bchjp->bchip", w[..., j0:j0 + step], xdt[..., j0:j0 + step, :])
    return y


@pytest.mark.parametrize("b,nc,q,n,h,p", [(1, 2, 64, 32, 2, 16), (1, 1, 128, 20, 3, 24)])
def test_ssd_tf32_split_keeps_the_f32_function(b, nc, q, n, h, p):
    """Three TF32 products per f32 product hold the reference's Pallas kernel
    (interpret) at 1e-4; one TF32 term alone does not."""
    arrs = _ssd_inputs(b, nc, q, n, h, p, seed=q + n, decay=0.1)
    want = np.asarray(ref_ssd.ssd_intra_chunk(*map(jnp.asarray, arrs)))
    tensors = [torch.from_numpy(a) for a in arrs]
    got = _split_tf32_ssd(*tensors)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    one = _split_tf32_ssd(*tensors, terms=1)
    assert not np.allclose(one.numpy(), want, atol=ATOL, rtol=RTOL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The emulation's TF32 keeps 10 mantissa bits, rounds to nearest with
    ties away from zero, and leaves a remainder that is exact in f32."""
    one = 1.0 + 2.0 ** -10  # a TF32 value
    x = torch.tensor([one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([one, one, -one, 1.0, 1.0 + 2.0 ** -9], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = _tf32(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi.double() + (r - hi).double(), r.double())
