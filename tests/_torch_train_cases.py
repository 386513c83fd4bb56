"""Shared cases of the training parity tests through the sharded and the
streamed GNN engines (``test_torch_train_sharded.py``,
``test_torch_train_streamed.py``).

The same cora-sized graph (200 nodes, REDUCED widths, 64-lane tiles) and the
same parameters go through the reference under ``jax.grad`` and through the
port under ``torch.autograd`` on the CPU, where the port runs its kernels'
plain versions. Mixed-precision results are held at the cross-implementation
tolerance (``tests/test_gnn_models.py:66-80``), float ones at the f32
tolerance (``tests/test_gnn_models.py:46``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_mixed_close, cfg_pair, params_pair
from repro.graphs import datasets as ref_ds
from repro.memory.feature_store import FeatureStore as RefStore
from repro.memory.prefetcher import StreamedFeatures as RefStreamed
from repro.models.gnn import api as ref_api
from repro.optim import adamw as ref_adamw
from repro_torch.graphs import datasets as port_ds
from repro_torch.memory.feature_store import FeatureStore
from repro_torch.memory.prefetcher import StreamedFeatures
from repro_torch.models.gnn import api as port_api
from repro_torch.optim import adamw as port_adamw

ARCHS = ["gcn", "gin", "sage", "gat"]
EPT, NODES, CHUNK = 64, 200, 32
ATOL, RTOL = 5e-4, 1e-3  # f32 paths, tests/test_gnn_models.py:46


@functools.lru_cache(maxsize=None)
def case(arch, precision="mixed"):
    """(ref cfg, port cfg, ref prepared graph, port prepared graph, ref
    params, port params, loss weights r, features)."""
    rcfg, pcfg = cfg_pair(arch, gnn_edges_per_tile=EPT, gnn_precision=precision)
    kw = dict(max_nodes=NODES, max_feature_dim=rcfg.d_model, seed=0)
    rg, pg = ref_ds.make_dataset("cora", **kw), port_ds.make_dataset("cora", **kw)
    rp, pp = params_pair(rcfg, pcfg, seed=0)
    r = np.random.default_rng(1).standard_normal(
        (rg.num_nodes, rcfg.gnn_layer_dims[-1])).astype(np.float32)
    return (rcfg, pcfg, ref_api.prepare_graph(rcfg, rg), port_api.prepare_graph(pcfg, pg),
            rp, pp, r, rg.features)


def ref_loss(rcfg, eng, x, r):
    def loss(p):
        y = ref_api.gnn_apply(rcfg, p, eng, x)
        return jnp.sum(y * r), y
    return loss


@functools.lru_cache(maxsize=None)
def ref_sharded(arch, precision, k, partitioner):
    """(output, gradient leaves) of the reference's sharded engine: eager
    for mixed precision (under ``jax.jit`` XLA rounds the quantization
    differently and flips int8 codes the reference's own eager path does
    not), jitted for float."""
    rcfg, _, rgp, _, rp, _, r, feats = case(arch, precision)
    eng = ref_api.make_engine(rcfg, rgp, num_shards=k, partitioner=partitioner)
    f = jax.grad(ref_loss(rcfg, eng, jnp.asarray(feats), r), has_aux=True)
    grads, y = (f if precision == "mixed" else jax.jit(f))(rp)
    return np.asarray(y), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@functools.lru_cache(maxsize=None)
def ref_streamed(arch):
    """(output, gradient leaves) of the reference's streamed features at ¼."""
    rcfg, _, rgp, _, rp, _, r, feats = case(arch)
    sf = ref_streamed_features(feats, 4)
    grads, y = jax.grad(ref_loss(rcfg, ref_api.make_engine(rcfg, rgp), sf, r),
                        has_aux=True)(rp)
    return np.asarray(y), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def trainable(pp):
    return jax.tree_util.tree_map(lambda t: t.detach().clone().requires_grad_(), pp)


def port_grads(pcfg, pp, eng, x, r):
    """(output, gradient leaves in the reference's tree order)."""
    params = trainable(pp)
    leaves = jax.tree_util.tree_leaves(params)
    y = port_api.gnn_apply(pcfg, params, eng, x)
    return y.detach(), torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)


def close(got, want, precision):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    if precision == "mixed":
        assert_mixed_close(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def check(y, grads, want, precision):
    want_y, want_g = want
    close(y, want_y, precision)
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        assert g.shape == w.shape and torch.isfinite(g).all()
        close(g, w, precision)
    assert any(float(np.abs(w).max()) > 0 for w in want_g)


def streamed(feats, frac):
    """The port's streamed features at ``1/frac`` of the store."""
    return StreamedFeatures(FeatureStore.from_array(feats, chunk_rows=CHUNK),
                            feats.nbytes // frac, device="cpu")


def ref_streamed_features(feats, frac):
    return RefStreamed(RefStore.from_array(feats, chunk_rows=CHUNK), feats.nbytes // frac)


def adamw_run(grad_fn, p0, opt_mod, cfg, to_tree, steps=3):
    p, s = to_tree(p0), opt_mod.adamw_init(to_tree(p0))
    for _ in range(steps):
        p, s, _ = opt_mod.adamw_update(grad_fn(p), s, p, cfg)
    return p


def adamw_steps_match_reference(arch, path):
    """Three AdamW steps through ``path`` ("sharded": 2 shards, halo
    overlap on; "streamed": ¼ of the store) on a float engine against the
    reference's steps through its own."""
    rcfg, pcfg, rgp, pgp, rp, pp, r, feats = case(arch, "float")
    if path == "sharded":
        reng = ref_api.make_engine(rcfg, rgp, num_shards=2)
        peng = port_api.make_engine(pcfg, pgp, num_shards=2, halo_overlap=True)
        rx, px = jnp.asarray(feats), torch.from_numpy(feats)
    else:
        reng, peng = ref_api.make_engine(rcfg, rgp), port_api.make_engine(pcfg, pgp)
        rx, px = ref_streamed_features(feats, 4), streamed(feats, 4)
    rgrad = jax.grad(lambda p: ref_loss(rcfg, reng, rx, r)(p)[0])
    if path == "sharded":
        rgrad = jax.jit(rgrad)

    def pgrad(p):
        leaves = jax.tree_util.tree_leaves(p)
        y = port_api.gnn_apply(pcfg, p, peng, px)
        flat = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(p), list(flat))

    lr = 5e-3
    want = adamw_run(rgrad, rp, ref_adamw, ref_adamw.AdamWConfig(lr=lr), lambda t: t)
    got = adamw_run(pgrad, pp, port_adamw, port_adamw.AdamWConfig(lr=lr), trainable)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=0.02 * lr, rtol=0)
