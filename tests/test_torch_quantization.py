"""The port's int8 quantization is bitwise the reference's.

Both round half to even (``torch.round`` / ``jnp.round``) and keep Eq. 5's
operation order: round(x / s + z), clip, cast; dequant (q - z) * s.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as ref_q
from repro_torch.core import quantization as port_q


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 37)) * rng.uniform(0.01, 10.0)).astype(np.float32)
    amax = np.abs(x).max()
    x[0, :5] = amax * np.array([0.5, -0.5, 1.5, -2.5, 1.0]) / 127  # half steps
    return x


def _eq(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("symmetric", [True, False])
def test_per_tensor_bitwise(seed, symmetric):
    x = _inputs(seed)
    rq = ref_q.compute_scale_zp(jnp.asarray(x), symmetric=symmetric)
    pq = port_q.compute_scale_zp(torch.from_numpy(x), symmetric=symmetric)
    _eq(rq.scale, pq.scale)
    _eq(rq.zero_point, pq.zero_point)
    codes = port_q.quantize(torch.from_numpy(x), pq)
    assert codes.dtype == torch.int8
    _eq(ref_q.quantize(jnp.asarray(x), rq), codes)
    _eq(ref_q.dequantize(ref_q.quantize(jnp.asarray(x), rq), rq), port_q.dequantize(codes, pq))


@pytest.mark.parametrize("axis", [-1, 0])
def test_per_channel_bitwise(axis):
    w = _inputs(11)
    rw, rqp = ref_q.quantize_per_channel(w, axis=axis)
    pw, pqp = port_q.quantize_per_channel(torch.from_numpy(w), axis=axis)
    _eq(rw, pw)
    _eq(rqp.scale, pqp.scale)


def test_clip_and_all_zero_input():
    x = torch.zeros((4, 4))
    qp = port_q.compute_scale_zp(x)
    assert float(qp.scale) == np.float32(1e-8)
    assert torch.equal(port_q.quantize(x, qp), torch.zeros((4, 4), dtype=torch.int8))
    big = torch.tensor([1e9, -1e9])
    one = port_q.QuantParams(torch.tensor(1.0), torch.tensor(0.0))
    assert port_q.quantize(big, one).tolist() == [127, -128]


@pytest.mark.parametrize("d", [300, 20, 256])
def test_quantize_into_rows_at_a_wider_stride(d):
    """Codes written into the first d columns of a wider buffer (the int8
    group's rows at a 16-byte stride) are the codes quantize returns, and
    the padding is left as it was."""
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((40, d)).astype(np.float32))
    qp = port_q.compute_scale_zp(x, symmetric=True)
    buf = torch.full((40, -(-d // 16) * 16), 9, dtype=torch.int8)
    got = port_q.quantize(x, qp, out=buf[:, :d])
    assert got.data_ptr() == buf.data_ptr() and got.stride(0) == buf.shape[1]
    assert torch.equal(got, port_q.quantize(x, qp))
    assert (buf[:, d:] == 9).all()
