"""The port's particle-mesh stage (nbody_tpu_torch/ops/pm_forces.py) against
nbody_tpu's, on the same numpy inputs: the adaptive box and the CIC cell
indices bit for bit, the forces within a stated fraction of max|a|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

import nbody_tpu as nb
from nbody_tpu.ops import pm_forces as jpm
import nbody_tpu_torch as nt
from nbody_tpu_torch.ops import pm_forces as tpm

# Forces: max|Δa|/max|a| < 1e-5. Both sides run the same fp32 formulas on
# bit-identical cells and weights; they differ in the FFT library (pocketfft
# vs ducc), which sums each transform in another order, and in the order of
# the CIC scatter's sums. Measured up to 5.5e-6 here (grid 128).
TOL = 1e-5


def _scene(n, galaxies=2, seed=11037):
    """A JAX world's (pos, radius, src_pos, gm) as numpy, massive first."""
    w = nb.create_world(nb.make_galaxies(n, galaxies, seed=seed))
    pos = np.array(w.state.pos[:w.total_len])
    radius = np.array(w.state.radius[:w.total_len])
    gm = np.array(w.gm[:w.mass_len])
    return pos, radius, pos[:w.mass_len].copy(), gm


@pytest.mark.parametrize("n", [1, 100, 4096, 65536, 1 << 20, 1 << 26])
def test_suggest_grid_matches(n):
    assert nt.suggest_grid(n) == jpm.suggest_grid(n)


@pytest.mark.parametrize("n,grid", [(2048, 256), (4096, 128), (3000, 512)])
def test_box_and_cic_weights_bit_exact(n, grid):
    pos, _, src, gm = _scene(n)
    lo_j, h_j = jpm._box(*jpm._bounds(jnp.asarray(pos), jnp.asarray(src),
                                      jnp.asarray(gm), None), grid)
    tp = torch.from_numpy(pos)
    lo_t, h_t = tpm._box(*tpm._bounds(tp, torch.from_numpy(src),
                                      torch.from_numpy(gm)), grid)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    assert float(h_t) == float(h_j)
    want = jpm._cic_weights(jnp.asarray(pos), lo_j, 1.0 / h_j, grid)
    got = tpm._cic_weights(tp, lo_t, 1.0 / h_t, grid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bounds_mask_and_zero_gm_rows():
    """Zero-gm sources and masked targets do not widen the box."""
    pos, _, src, gm = _scene(1000)
    far = np.array([[1e5, 1e5]], np.float32)
    pos2 = np.concatenate([pos, far])
    src2 = np.concatenate([src, far])
    gm2 = np.concatenate([gm, np.zeros(1, np.float32)])
    mask = np.concatenate([np.ones(len(pos), np.float32), np.zeros(1, np.float32)])
    want = jpm._bounds(jnp.asarray(pos2), jnp.asarray(src2), jnp.asarray(gm2),
                       jnp.asarray(mask))
    got = tpm._bounds(*map(torch.from_numpy, (pos2, src2, gm2, mask)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert float(g.abs().max()) < 1e5


@pytest.mark.parametrize("n,grid", [(2048, 256), (4096, 128), (3000, 512)])
def test_pm_acc_matches_nbody_tpu(n, grid):
    pos, _, src, gm = _scene(n)
    want = jpm.pm_acc(jnp.asarray(pos), jnp.asarray(src), jnp.asarray(gm), 2.0,
                      grid=grid)
    got = nt.pm_acc(*map(torch.from_numpy, (pos, src, gm)), 2.0, grid=grid)
    assert got.dtype == torch.float32 and tuple(got.shape) == pos.shape
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_world_pm_matches_nbody_tpu(integrator):
    """5 substeps of the pm backend: the force difference above, carried
    through 5 evaluations (measured below 3e-7 of max|x|)."""
    scene_t = nt.make_galaxies(1500, 1, seed=5)
    scene_j = nb.make_galaxies(1500, 1, seed=5)
    w_t = nt.create_world(scene_t, config=nt.SimConfig(
        pm_grid=128, integrator=integrator), device="cpu")
    w_j = nb.create_world(scene_j, config=nb.SimConfig(
        pm_grid=128, integrator=integrator))
    w_t.update(0.01, 5, backend="pm")
    w_j.update(0.01, 5, backend="pm")
    assert rel_err(w_t.particles.pos, w_j.particles.pos) < 1e-6
    assert rel_err(w_t.particles.acc, w_j.particles.acc) < TOL
