"""Helpers shared by the port's parity tests (``test_torch_*.py``).

Inputs are made once with numpy and handed to both packages: the JAX
reference ``repro`` and the PyTorch port ``repro_torch`` (on the CPU, where
the port runs its kernels' plain versions).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from repro.configs.base import get_config as ref_config
from repro.models.gnn import api as ref_api
from repro_torch.configs.base import get_config as port_config
from repro_torch.models.gnn import api as port_api

# Mixed precision across implementations (tests/test_gnn_models.py:66-80):
# summation order differs, so a one-ulp difference can flip an int8 code.
MIXED_ATOL, MIXED_RTOL, FLIP, FLIP_SHARE = 6e-2, 2e-3, 2e-3, 0.05


def cfg_pair(arch: str = "gcn", *, reduced: bool = True, **overrides):
    """The same ModelConfig in both packages (reference, port)."""
    ref = dataclasses.replace(ref_config(f"ample-{arch}", reduced=reduced), **overrides)
    port = dataclasses.replace(port_config(f"ample-{arch}", reduced=reduced), **overrides)
    return ref, port


def params_pair(ref_cfg, port_cfg, seed: int):
    """Reference params from its own init, carried into the port on the CPU."""
    rp = ref_api.gnn_init(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, rp)
    return rp, port_api.params_from_numpy(port_cfg, tree, device="cpu")


def assert_mixed_close(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=MIXED_ATOL, rtol=MIXED_RTOL)
    assert (np.abs(got - want) > FLIP).mean() < FLIP_SHARE  # isolated code flips only
