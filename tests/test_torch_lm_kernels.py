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
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.ssd_scan import ops as ref_ssd
from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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


def test_flash_wrapper_checks_shapes_and_runs_plain_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 16, seed=0))
    build.reset_launch_counts()
    out = fa_ops.flash_attention(q, k, v)
    assert build.launch_counts() == {}  # CPU tensors: no kernel launch
    assert torch.equal(out, flash_attention_ref(q, k, v))
    with pytest.raises(ValueError, match="S <= T"):
        fa_ops.flash_attention(q, k[:, :5], v[:, :5])
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
