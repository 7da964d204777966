"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py).

Imports neither JAX nor ``nbody_tpu``, so the card-only tests that use it
run on a machine without JAX.
"""

import os

import numpy as np
import pytest
import torch

from nbody_tpu_torch.utils.ref_dump import load_hex_dump  # noqa: F401 (re-export)

# The tier-1 run spreads test files over several worker processes; two
# intra-op threads each keeps them from oversubscribing the cores.
torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
REF_TRAJ = "ref_traj_n2000_g2_seed11037_s{steps}_dt0.01.hex"


def random_arrays(n, seed=0, massless_frac=0.3):
    """numpy (pos, vel, mass, radius) in float32: positions ~100 apart,
    ~30% massless tracers of radius 0.5 (the mix of tests/helpers.py)."""
    rng = np.random.default_rng(seed)
    pos = (100 * rng.normal(size=(n, 2))).astype(np.float32)
    vel = rng.normal(size=(n, 2)).astype(np.float32)
    massless = rng.uniform(size=n) < massless_frac
    radius = np.where(massless, 0.5, rng.uniform(1.5, 9.5, n)).astype(np.float32)
    mass = np.where(massless, 0.0, rng.uniform(10, 1e4, n)).astype(np.float32)
    return pos, vel, mass, radius


def rel_err(got, want):
    """max |got - want| / max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def cuda():
    """The CUDA device, or a skip when this machine has none. Decided while
    the test runs, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")
