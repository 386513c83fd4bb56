"""The SSD intra-chunk backward's plain version against the reference, on the CPU.

The reference's Pallas kernel (``repro/kernels/ssd_scan/ssd_scan.py``) has no
VJP, so its oracle is the gradient of ``repro.kernels.ssd_scan.ref
.ssd_intra_chunk_ref``: ``jax.vjp`` of it against the port's
``ssd_intra_chunk_bwd_ref``, which uses explicit formulas and no autograd;
then the wrapper's autograd Function on CPU tensors against autograd through
the plain forward. Inputs are made with numpy from a seed, the log-decay a
realistic negative cumsum (tests/test_torch_lm_kernels.py). Tolerance: each
gradient within 1e-4 of its largest magnitude (the kernels' 1e-4; sums over
up to 256 keys in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_intra_chunk_ref as jax_ssd_ref
from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_bwd_ref, ssd_intra_chunk_ref

REL = 1e-4
NAMES = ("dcc", "dbc", "dxdt", "dacum")

# (B, NC, Q, N, H, P): small; a ragged Q against the 64-row tiles; Q = 1;
# Jamba's N 16 with more heads than state columns; a chunk of 256 as Mamba's.
SHAPES = [
    (1, 2, 16, 8, 2, 8),
    (2, 1, 70, 12, 3, 6),
    (1, 3, 1, 4, 2, 5),
    (1, 1, 64, 16, 8, 4),
    (1, 1, 256, 8, 2, 4),
]


def _inputs(b, nc, q, n, h, p, seed, decay=0.05):
    rng = np.random.default_rng(seed)
    cc = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    bc = rng.standard_normal((b, nc, q, n)).astype(np.float32)
    xdt = rng.standard_normal((b, nc, h, q, p)).astype(np.float32)
    acum = -np.cumsum(rng.uniform(size=(b, nc, h, q)) * decay, axis=-1).astype(np.float32)
    dy = rng.standard_normal((b, nc, h, q, p)).astype(np.float32)
    return cc, bc, xdt, acum, dy


def _close(got, want):
    """Each gradient within REL of its largest magnitude (an all-zero
    gradient, dacum at Q = 1, is held exactly)."""
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert float(np.abs(np.asarray(g) - w).max()) <= REL * scale, name


@pytest.mark.parametrize("b,nc,q,n,h,p", SHAPES)
def test_plain_backward_matches_jax_vjp_of_the_reference(b, nc, q, n, h, p):
    cc, bc, xdt, acum, dy = _inputs(b, nc, q, n, h, p, seed=q * 7 + h)
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, (cc, bc, xdt, acum)))
    want = vjp(jnp.asarray(dy))
    got = ssd_intra_chunk_bwd_ref(*map(torch.from_numpy, (cc, bc, xdt, acum, dy)))
    _close([g.numpy() for g in got], want)


@pytest.mark.parametrize("b,nc,q,n,h,p", SHAPES[:3])
def test_function_on_cpu_matches_autograd_of_the_plain_forward(b, nc, q, n, h, p):
    """Under grad the wrapper runs ``SSDIntraChunkFunction``; on CPU tensors
    its gradient (the plain backward, dy given as a permuted view as the
    layer hands it) is autograd's through the plain forward, and no launch
    is counted."""
    cc, bc, xdt, acum, dy = map(torch.from_numpy, _inputs(b, nc, q, n, h, p, seed=q + n))
    dyv = dy.permute(0, 1, 3, 2, 4).contiguous().permute(0, 1, 3, 2, 4)
    leaves = [t.clone().requires_grad_() for t in (cc, bc, xdt, acum)]
    build.reset_launch_counts()
    out = ssd_ops.ssd_intra_chunk(*leaves)
    assert out.grad_fn is not None and "SSDIntraChunkFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, dyv)
    assert build.launch_counts() == {}
    plain = [t.clone().requires_grad_() for t in (cc, bc, xdt, acum)]
    want = torch.autograd.grad(ssd_intra_chunk_ref(*plain), plain, dy)
    _close([g.numpy() for g in got], [w.numpy() for w in want])
    torch.testing.assert_close(out.detach(), ssd_intra_chunk_ref(cc, bc, xdt, acum))


def test_grad_through_some_inputs_only_and_no_grad_skips_the_function():
    cc, bc, xdt, acum, dy = map(torch.from_numpy, _inputs(1, 1, 20, 4, 2, 3, seed=1))
    x = xdt.clone().requires_grad_()
    (gx,) = torch.autograd.grad(ssd_ops.ssd_intra_chunk(cc, bc, x, acum), [x], dy)
    torch.testing.assert_close(gx, ssd_intra_chunk_bwd_ref(cc, bc, xdt, acum, dy)[2])
    with torch.no_grad():
        assert ssd_ops.ssd_intra_chunk(cc, bc, x, acum).grad_fn is None


def test_plain_backward_keeps_large_decays_finite():
    """A steep decay over a chunk of 256 (a_i − a_j above the diagonal up to
    ~+260, past f32's exp range): the reference's f32 gradient turns NaN
    there (its exp of the masked pairs overflows and meets a zero
    cotangent), the port's stays finite, since its decay is formed only for
    i ≥ j, and matches the reference's gradient taken in float64."""
    arrs = _inputs(1, 1, 256, 8, 2, 4, seed=3, decay=2.0)
    got = ssd_intra_chunk_bwd_ref(*map(torch.from_numpy, arrs))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, arrs[:4]))
    assert not np.isfinite(np.asarray(vjp(jnp.asarray(arrs[4]))[3])).all()
    with jax.enable_x64(True):
        _, vjp = jax.vjp(jax_ssd_ref, *(jnp.asarray(a, jnp.float64) for a in arrs[:4]))
        want = [np.asarray(w) for w in vjp(jnp.asarray(arrs[4], jnp.float64))]
    _close([g.numpy() for g in got], want)


def test_backward_wrapper_checks_shapes_and_devices():
    cc, bc, xdt, acum, dy = map(torch.from_numpy, _inputs(1, 2, 16, 8, 2, 8, seed=0))
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_intra_chunk_bwd(cc, bc, xdt, acum, dy[..., :4])
    with pytest.raises(ValueError, match="acum"):
        ssd_ops.ssd_intra_chunk_bwd(cc, bc, xdt, acum[..., :1, :], dy)
    meta = [t.to("meta") for t in (cc, bc, xdt, acum, dy)]
    with pytest.raises(ValueError, match="no SSD kernel for device meta"):
        ssd_ops.ssd_intra_chunk_bwd(*meta)
    assert "ssd_intra_chunk" not in build._BACKWARD


@pytest.mark.parametrize("chunks,tiles,heads,want", [
    (32, 4, 32, 16),    # Mamba2-370M training: 128 key tiles -> 2 runs of 16 heads, 256 blocks
    (32, 4, 128, 64),   # Jamba's 128 heads: 2 runs of 64
    (8, 1, 8, 4),       # the REDUCED launcher: 17 runs wanted, 2 of 4 heads (the fewest a run)
    (8, 4, 32, 7),      # 5 runs wanted: runs of 7 heads, the last of 4
    (20, 4, 32, 16),    # 2 runs wanted
    (6, 4, 32, 6),      # 6 runs wanted: runs of 6 heads, the last of 2
    (4, 1, 128, 16),    # 33 runs wanted, 8 at most
    (132, 1, 32, 32),   # a grid of one block an SM stays whole
    (1, 2, 3, 3),       # fewer heads than a run takes: one run
    (1, 1, 1, 1),
])
def test_bwd_heads_per_run_fill_the_card_with_no_empty_run(chunks, tiles, heads, want):
    hpr = ssd_ops.bwd_heads_per_run(chunks, tiles, heads, sms=132)
    assert hpr == want
    runs = -(-heads // hpr)
    assert 1 <= runs <= ssd_ops.BWD_MAX_RUNS
    assert (runs - 1) * hpr < heads <= runs * hpr
