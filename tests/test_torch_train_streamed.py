"""Training through streamed features (``StreamedFeatures``: the
out-of-core path) against ``jax.grad`` of the reference's streamed path,
which reads host scalars and runs eagerly.

Cases and tolerances are ``_torch_train_cases.py``'s. The streamed FTE's
gradient is held bitwise to the in-memory one, and GIN's streamed residual
keeps its bits with grad off.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_train_cases as C
from repro_torch.memory.prefetcher import scale_add_streamed
from repro_torch.models.gnn import api as port_api


# ----------------------------------------------------- streamed, against jax.grad
@pytest.mark.parametrize("frac", [4, 10])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_streamed_grads_match_reference(arch, frac):
    """Gradients through ``StreamedFeatures`` (¼ and 1/10 of the store: the
    chunk cache evicts) against the reference's streamed ``jax.grad``, and
    bitwise the port's in-memory gradients where no gradient sums over the
    chunks (GIN's ``eps`` does)."""
    _, pcfg, _, pgp, _, pp, r, feats = C.case(arch)
    eng = port_api.make_engine(pcfg, pgp)
    sf = C.streamed(feats, frac)
    y, grads = C.port_grads(pcfg, pp, eng, sf, r)
    assert sf.stats.bytes_streamed > 0
    C.check(y, grads, C.ref_streamed(arch), "mixed")
    y_mem, in_memory = C.port_grads(pcfg, pp, eng, torch.from_numpy(feats), r)
    assert torch.equal(y, y_mem)
    for g, w in zip(grads, in_memory):
        if arch == "gin":
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=C.ATOL, rtol=C.RTOL)
        else:
            assert torch.equal(g, w)


def test_scale_add_streamed_gives_eps_and_m_their_gradients():
    """GIN's streamed residual ``alpha · x + m``: under grad ``alpha`` and
    ``m`` receive the dense gradient; with grad off the output is the same
    bits as before (``torch.add`` into one buffer, chunk by chunk)."""
    x = np.random.default_rng(3).standard_normal((150, 6)).astype(np.float32)
    sf = C.streamed(x, 4)
    gen = torch.Generator().manual_seed(4)
    eps = torch.tensor(0.3, requires_grad=True)
    m = torch.randn((150, 6), generator=gen, requires_grad=True)
    w = torch.randn((150, 6), generator=gen)
    got = scale_add_streamed(sf, 1.0 + eps, m)
    want = (1.0 + eps) * torch.from_numpy(x) + m
    assert torch.equal(got, want)
    for g, ww in zip(torch.autograd.grad((got * w).sum(), [eps, m]),
                     torch.autograd.grad((want * w).sum(), [eps, m])):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        served = scale_add_streamed(sf, 1.0 + eps, m)
    before = torch.empty_like(m)
    for c in range(sf.store.num_chunks):
        lo, hi = sf.store.chunk_range(c)
        torch.add((1.0 + eps.detach()) * torch.from_numpy(x[lo:hi]), m.detach()[lo:hi],
                  out=before[lo:hi])
    assert torch.equal(served, before)


def test_streamed_int8_fte_gradient_is_the_in_memory_one():
    """The int8 FTE over streamed features under grad: output, weight and
    bias gradients bitwise ``transform`` on the dense matrix."""
    _, pcfg, _, pgp, _, pp, r, feats = C.case("sage")
    eng = port_api.make_engine(pcfg, pgp)
    gen = torch.Generator().manual_seed(5)
    w = torch.randn((feats.shape[1], 7), generator=gen, requires_grad=True)
    b = torch.randn((7,), generator=gen, requires_grad=True)
    gy = torch.randn((feats.shape[0], 7), generator=gen)
    outs = []
    for x in (C.streamed(feats, 10), torch.from_numpy(feats)):
        y = eng.transform(x, w, b, torch.relu)
        outs.append([y.detach(), *torch.autograd.grad((y * gy).sum(), [w, b])])
    assert all(torch.equal(a, c) for a, c in zip(*outs))
    assert float(outs[0][1].abs().max()) > 0


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_adamw_steps_match_reference(arch):
    C.adamw_steps_match_reference(arch, "streamed")
