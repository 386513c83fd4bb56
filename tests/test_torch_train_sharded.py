"""Training through the sharded GNN engine (``ShardedAmpleEngine``, the
host loop) against ``jax.grad`` of the reference's sharded engine.

Cases and tolerances are ``_torch_train_cases.py``'s. The reference's
gradients run under ``jax.jit`` for float engines (its host loop traces
with ``halo_overlap`` off, and its overlapped schedule is bitwise the
unsplit one) and eagerly for mixed precision. What the port must reproduce
exactly is held bitwise: the overlapped halo schedule against the unsplit
one, a forward under grad against the served output.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_train_cases as C
from repro_torch.distributed.graph_shard import ShardedAmpleEngine, halo_transpose_plan
from repro_torch.graphs import datasets as port_ds
from repro_torch.models.gnn import api as port_api
from repro_torch.serve.gnn_engine import GNNServeEngine


# ----------------------------------------------------- sharded, against jax.grad
def _sharded_case(arch, precision, k, partitioner):
    """Every parameter's gradient through the sharded engine, halo overlap
    off and on (bitwise the same), against the reference's sharded
    ``jax.grad``."""
    _, pcfg, _, pgp, _, pp, r, feats = C.case(arch, precision)
    want = C.ref_sharded(arch, precision, k, partitioner)
    runs = []
    for overlap in (False, True):
        eng = port_api.make_engine(pcfg, pgp, num_shards=k, partitioner=partitioner,
                                   halo_overlap=overlap)
        assert isinstance(eng, ShardedAmpleEngine)
        y, grads = C.port_grads(pcfg, pp, eng, torch.from_numpy(feats), r)
        C.check(y, grads, want, precision)
        runs.append(grads)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    return runs[0]


@pytest.mark.parametrize("partitioner", ["edges", "mincut"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_grads_match_reference(arch, k, partitioner):
    """Float engines at K 2 and 4, both partitioners: the f32 tolerance,
    against the reference and against the port's unsharded engine."""
    grads = _sharded_case(arch, "float", k, partitioner)
    _, pcfg, _, pgp, _, pp, r, feats = C.case(arch, "float")
    _, unsharded = C.port_grads(pcfg, pp, port_api.make_engine(pcfg, pgp),
                               torch.from_numpy(feats), r)
    for g, w in zip(grads, unsharded):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=C.ATOL, rtol=C.RTOL)


@pytest.mark.parametrize("k, partitioner", [(2, "edges"), (4, "mincut")])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_mixed_grads_match_reference(arch, k, partitioner):
    """Mixed-precision engines (the int8 group's scale gradient summed over
    the shards): the mixed tolerance."""
    _sharded_case(arch, "mixed", k, partitioner)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_forward_under_grad_is_the_served_output(arch):
    """The forward that training differentiates is the serving forward, bit
    for bit: under grad, under ``no_grad`` and served."""
    _, pcfg, _, pgp, _, pp, r, feats = C.case(arch)
    eng = port_api.make_engine(pcfg, pgp, num_shards=2, halo_overlap=True)
    y, _ = C.port_grads(pcfg, pp, eng, torch.from_numpy(feats), r)
    with torch.no_grad():
        served = port_api.gnn_apply(pcfg, pp, eng, torch.from_numpy(feats))
    assert torch.equal(y, served)
    srv = GNNServeEngine(pcfg, pp, num_shards=2, halo_overlap=True, device="cpu")
    g = port_ds.make_dataset("cora", max_nodes=C.NODES, max_feature_dim=pcfg.d_model, seed=0)
    np.testing.assert_array_equal(srv.infer(g, feats).outputs, served.numpy())


# ----------------------------------------------------- the pieces under grad
def test_halo_transpose_plan_sums_every_copy_in_stacked_order():
    """Each node's segment holds the stacked positions of its local copies,
    ascending (shard by shard, owned before halo), each position once; the
    local rows' gradient is their sum by node."""
    _, pcfg, _, pgp, *_ = C.case("gcn")
    eng = port_api.make_engine(pcfg, pgp, num_shards=4, partitioner="mincut")
    splan = eng.sharded_plan
    ids = np.concatenate([sp.shard.local_ids for sp in splan.shards])
    plan = halo_transpose_plan(splan, edges_per_tile=C.EPT, segments_per_tile=None)
    node = np.take_along_axis(plan.out_node, plan.seg_ids, axis=1)
    live = plan.edge_ids >= 0
    pos, dst = plan.gather_idx[live], node[live]
    assert np.array_equal(np.sort(pos), np.arange(ids.size))
    assert np.array_equal(ids[pos], dst)
    for v in np.unique(dst):
        assert np.all(np.diff(pos[dst == v]) > 0)
    x = torch.randn((pgp.num_nodes, 5), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    rows = eng._local_rows(x)
    ws = [torch.randn(t.shape, generator=torch.Generator().manual_seed(k + 1))
          for k, t in enumerate(rows)]
    (gx,) = torch.autograd.grad(sum((t * w).sum() for t, w in zip(rows, ws)), [x])
    want = torch.zeros_like(x).index_add_(0, torch.from_numpy(ids), torch.cat(ws))
    np.testing.assert_allclose(gx.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("partitioner", ["edges", "mincut"])
def test_sharded_edge_scores_forward_bitwise_and_grad(partitioner):
    """GAT's score gather under grad on the sharded engine: the forward
    bitwise the plain indexing, the halves' gradients the unsharded
    engine's."""
    _, pcfg, _, pgp, *_ = C.case("gat")
    eng = port_api.make_engine(pcfg, pgp, num_shards=3, partitioner=partitioner)
    ref = port_api.make_engine(pcfg, pgp)
    gen = torch.Generator().manual_seed(2)
    n, e = pgp.num_nodes, pgp.num_edges
    halves = [torch.randn((n, 2), generator=gen, requires_grad=True) for _ in range(2)]
    w = torch.randn((e, 2), generator=gen)
    src, dst = eng.edge_endpoints("cpu")
    got = eng.edge_scores(*halves)
    assert torch.equal(got, halves[0][src] + halves[1][dst])
    grads = torch.autograd.grad((got * w).sum(), halves)
    want = torch.autograd.grad((ref.edge_scores(*halves) * w).sum(), halves)
    for g, ww in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), atol=1e-5, rtol=1e-5)


def test_sharded_engine_caches_its_training_plans():
    """Transposed plans, ``TileGrad``s and the halo-transpose plan are built
    on the first step and reused: a warm step builds none."""
    _, pcfg, _, pgp, _, pp, r, feats = C.case("gat")
    eng = port_api.make_engine(pcfg, pgp, num_shards=2)
    C.port_grads(pcfg, pp, eng, torch.from_numpy(feats), r)
    kinds = ("transposed", "tile_grad", "halo_transpose")
    cold = {k for k in eng._shard_state if k[0] in kinds}
    assert {k[0] for k in cold} == set(kinds)
    ids = {k: id(eng._shard_state[k]) for k in cold}
    C.port_grads(pcfg, pp, eng, torch.from_numpy(feats), r)
    assert {k: id(eng._shard_state[k]) for k in eng._shard_state if k[0] in kinds} == ids


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_adamw_steps_match_reference(arch):
    C.adamw_steps_match_reference(arch, "sharded")
