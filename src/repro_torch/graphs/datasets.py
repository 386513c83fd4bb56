"""Synthetic graph datasets calibrated to the paper's Table 4.

There is no network access in this environment, so the six benchmark graphs
(Cora, CiteSeer, PubMed, Flickr, Reddit, Yelp) are *regenerated* as random
graphs whose node count, mean degree, feature width and degree skew match the
published statistics. Degree distributions of citation/social graphs are heavy
tailed; we draw degrees from a discretized lognormal calibrated so that

  * mean(degree)  == Table 4 mean degree,
  * max(degree)   is a large multiple of the mean (social graphs have hubs),

which is the property AMPLE's event-driven flow exploits (the double-buffered
baseline's cost is driven by the *max* degree per batch while AMPLE's is driven
by the *sum*). All generators are deterministic in ``seed``.

A copy of the reference's ``repro/graphs/datasets.py`` with the same
generator, ``_GEN_VERSION`` and cache key, so both packages build the same CSR
arrays and may share one structure cache directory.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.graphs.csr import Graph, from_edge_list

__all__ = [
    "DatasetSpec",
    "PAPER_DATASETS",
    "make_dataset",
    "make_lognormal_graph",
    "dataset_cache_dir",
]

#: Environment variable naming the on-disk dataset cache directory. Unset
#: (and no explicit ``cache_dir``) disables caching — generation stays pure.
CACHE_ENV = "REPRO_DATASET_CACHE"

#: Cache-key version of the structure generator. Bump on ANY change to
#: ``make_lognormal_graph``'s output so cached graphs can't go stale.
_GEN_VERSION = 1


def dataset_cache_dir() -> Optional[str]:
    """The configured on-disk cache directory, or None when disabled."""
    d = os.environ.get(CACHE_ENV, "").strip()
    return d or None


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    mean_degree: float
    feature_dim: int
    dq_float_ratio: float  # Table 4 "DQ ratio": fraction of nodes kept in float
    num_classes: int = 16
    sigma: float = 1.25  # lognormal shape: degree skew (hubs)


# Table 4 of the paper. (num_classes is not in the paper; chosen plausibly.)
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    "cora": DatasetSpec("cora", 2_708, 3.9, 1_433, 0.021, num_classes=7),
    "citeseer": DatasetSpec("citeseer", 3_327, 2.7, 3_703, 0.027, num_classes=6),
    "pubmed": DatasetSpec("pubmed", 19_717, 4.5, 500, 0.029, num_classes=3),
    "flickr": DatasetSpec("flickr", 89_250, 10.0, 500, 0.002, num_classes=7),
    "reddit": DatasetSpec("reddit", 232_965, 99.6, 602, 0.027, num_classes=41),
    "yelp": DatasetSpec("yelp", 716_847, 19.5, 300, 0.004, num_classes=100),
}


def _lognormal_degrees(
    n: int, mean_degree: float, sigma: float, rng: np.random.Generator
) -> np.ndarray:
    """Integer degree sequence with the requested mean and lognormal tail."""
    # E[lognormal(mu, sigma)] = exp(mu + sigma^2/2)  =>  solve mu for the mean.
    mu = np.log(max(mean_degree, 1e-6)) - 0.5 * sigma * sigma
    deg = rng.lognormal(mean=mu, sigma=sigma, size=n)
    deg = np.maximum(np.rint(deg), 1).astype(np.int64)
    deg = np.minimum(deg, n - 1 if n > 1 else 1)
    # Rescale-by-sampling to hit the target edge count nearly exactly: adjust a
    # random subset up/down by 1 until the total matches.
    target = int(round(mean_degree * n))
    diff = target - int(deg.sum())
    if diff != 0:
        idx = rng.permutation(n)
        step = 1 if diff > 0 else -1
        k = abs(diff)
        # nodes eligible for decrement must keep degree >= 1
        pos = 0
        while k > 0 and pos < n:
            i = idx[pos % n]
            nd = deg[i] + step
            if 1 <= nd <= n - 1:
                deg[i] = nd
                k -= 1
            pos += 1
    return deg


def make_lognormal_graph(
    num_nodes: int,
    mean_degree: float,
    *,
    sigma: float = 1.25,
    seed: int = 0,
    name: str = "synthetic",
) -> Graph:
    """Random CSR graph with lognormal in-degree distribution.

    Neighbour ids are sampled uniformly (with replacement then dedup within a
    row); the realized mean degree is within ~1% of the request after dedup.
    Built row-wise directly in CSR form to stay O(E) in memory.
    """
    rng = np.random.default_rng(seed)
    deg = _lognormal_degrees(num_nodes, mean_degree, sigma, rng)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, num_nodes, size=int(indptr[-1]), dtype=np.int64)
    # per-row sort + dedup (replace dups by resample once; residual dups get
    # dropped by compaction). Vectorized: sort (row, idx) pairs and mask repeats.
    rows = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    order = np.lexsort((indices, rows))
    rows, indices = rows[order], indices[order]
    dup = np.zeros(indices.shape[0], bool)
    if indices.size:
        dup[1:] = (indices[1:] == indices[:-1]) & (rows[1:] == rows[:-1])
    self_loop = indices == rows
    keep = ~(dup | self_loop)
    rows, indices = rows[keep], indices[keep]
    new_deg = np.zeros(num_nodes, np.int64)
    np.add.at(new_deg, rows, 1)
    # guarantee min degree 1 (isolated rows get one random neighbour)
    iso = np.nonzero(new_deg == 0)[0]
    if iso.size:
        extra = (iso + 1 + rng.integers(0, num_nodes - 1, iso.size)) % num_nodes
        rows = np.concatenate([rows, iso])
        indices = np.concatenate([indices, extra])
        order = np.lexsort((indices, rows))
        rows, indices = rows[order], indices[order]
        new_deg[iso] = 1
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(new_deg, out=indptr[1:])
    return Graph(
        indptr=indptr,
        indices=indices.astype(np.int32),
        num_nodes=num_nodes,
        name=name,
    )


def _cached_structure(
    cache_dir: str, spec: DatasetSpec, n: int, seed: int
) -> Graph:
    """Load (or generate-and-save) a graph *structure* from the disk cache.

    Keyed on everything that shapes the topology: a generator version (bump
    ``_GEN_VERSION`` whenever ``make_lognormal_graph``'s construction
    changes, or stale structures survive on disk), name, node count, mean
    degree, sigma and seed. Only the structure is cached — features are
    cheap to regenerate deterministically and would triple the disk
    footprint. The write is atomic (tmp + rename) so concurrent test
    workers never observe a half-written file.
    """
    key = (
        f"{spec.name}-n{n}-d{spec.mean_degree:g}-s{spec.sigma:g}-seed{seed}"
        f"-g{_GEN_VERSION}"
    )
    path = os.path.join(cache_dir, f"{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return Graph(
                indptr=z["indptr"],
                indices=z["indices"],
                num_nodes=int(z["num_nodes"]),
                name=str(z["name"]),
            )
    g = make_lognormal_graph(
        n, spec.mean_degree, sigma=spec.sigma, seed=seed, name=spec.name
    )
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"  # savez appends .npz otherwise
    np.savez(
        tmp,
        indptr=g.indptr,
        indices=g.indices,
        num_nodes=np.int64(g.num_nodes),
        name=np.str_(g.name),
    )
    os.replace(tmp, path)
    return g


def make_dataset(
    spec_or_name,
    *,
    seed: int = 0,
    with_features: bool = True,
    feature_scale: float = 1.0,
    max_nodes: Optional[int] = None,
    max_feature_dim: Optional[int] = None,
    cache_dir: Optional[str] = None,
) -> Graph:
    """Instantiate a paper dataset (optionally size-reduced for CPU benches).

    ``max_nodes`` / ``max_feature_dim`` scale the graph down proportionally —
    used by smoke tests and CPU wall-clock benches; the discrete-event
    simulator always uses the full published sizes.

    ``cache_dir`` (or the ``REPRO_DATASET_CACHE`` env var) enables an
    on-disk structure cache keyed on (spec, size, seed): regenerating yelp's
    717K-node lognormal graph dominates every large-graph test/bench run, so
    repeat processes load the CSR arrays instead. Cached loads are
    bit-identical to generation (asserted by tests).
    """
    spec = (
        spec_or_name
        if isinstance(spec_or_name, DatasetSpec)
        else PAPER_DATASETS[str(spec_or_name).lower()]
    )
    n = spec.num_nodes if max_nodes is None else min(spec.num_nodes, max_nodes)
    d = (
        spec.feature_dim
        if max_feature_dim is None
        else min(spec.feature_dim, max_feature_dim)
    )
    cdir = cache_dir if cache_dir is not None else dataset_cache_dir()
    if cdir:
        g = _cached_structure(cdir, spec, n, seed)
    else:
        g = make_lognormal_graph(
            n, spec.mean_degree, sigma=spec.sigma, seed=seed, name=spec.name
        )
    if with_features:
        rng = np.random.default_rng(seed + 1)
        feats = rng.standard_normal((n, d)).astype(np.float32) * feature_scale
        g = g.with_features(feats)
    return g
