"""Shared fixtures/strategies. NOTE: no XLA_FLAGS here — tests must see the
single real CPU device; only launch/dryrun.py fakes 512 devices.

``hypothesis`` is optional: when missing, property tests are skipped via the
stubs in ``_hypothesis_compat`` instead of dying at collection."""
from __future__ import annotations

import os

import numpy as np
import pytest

from _hypothesis_compat import HAVE_HYPOTHESIS

# Large-graph tests regenerate Table-4 lognormal graphs per process; cache
# the structures on disk (repo-local, gitignored) so repeat runs skip the
# dominant setup cost. Explicit REPRO_DATASET_CACHE settings win.
os.environ.setdefault(
    "REPRO_DATASET_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(__file__)), ".dataset-cache"),
)

if HAVE_HYPOTHESIS:
    from hypothesis import HealthCheck, settings

    # Property tests trace JAX under the hood — generous deadlines, no shrink spam.
    settings.register_profile(
        "repro",
        deadline=None,
        max_examples=25,
        suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
    )
    settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "hypothesis: property-based tests (require the hypothesis package; "
        "select with -m hypothesis, deselect with -m 'not hypothesis')",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels); skipped where there is none",
    )


def random_graph(n: int, mean_deg: float, seed: int):
    from repro.graphs.datasets import make_lognormal_graph

    return make_lognormal_graph(n, mean_deg, seed=seed)


@pytest.fixture(scope="session")
def small_cora():
    from repro.graphs import make_dataset

    return make_dataset("cora", max_nodes=200, max_feature_dim=24, seed=0)
