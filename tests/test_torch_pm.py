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

# Forces: max|Δa|/max|a| < 1e-5. Both sides run the same formulas on
# bit-identical cells and weights; they differ in the FFT library (pocketfft
# vs ducc), which sums each transform in another order, in the order of
# the CIC scatter's sums, and in the convolution's precision (float64 in
# the port's "pm" solve, ~3e-7 of max|a| from fp32). Measured up to 5.5e-6
# here (grid 128).
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


def _solve_float64(rho, h, eps2, grid):
    """The free-space convolution in numpy float64: the (G, G, 2) grid."""
    n2 = 2 * grid
    idx = np.arange(n2)
    d = np.where(idx < grid, idx, idx - n2).astype(np.float64)
    dx, dy = d[:, None] * float(h), d[None, :] * float(h)
    r2 = dx * dx + dy * dy + float(eps2)
    inv_r3 = 1.0 / (r2 * np.sqrt(r2))
    pad = np.zeros((n2, n2))
    pad[:grid, :grid] = rho.numpy()
    f = np.fft.rfft2(pad)
    out = [-np.fft.irfft2(f * np.fft.rfft2(k * inv_r3), s=(n2, n2))[:grid, :grid]
           for k in (dx, dy)]
    return np.stack(out, axis=-1)


def _horizon_grid():
    """tests/test_physics_validation.py:110's scene and grid (one galaxy,
    N=1024, grid 128, softening 2): its mass grid, h, and the world."""
    w = nt.create_world(nt.make_galaxies(1024, 1, seed=11037),
                        config=nt.SimConfig(pm_grid=128), device="cpu")
    pos, gm = w.state.pos, w.gm
    lo, h = tpm._box(*tpm._bounds(pos, pos[:w.mass_len], gm), 128)
    return tpm._cic_scatter(pos[:w.mass_len], gm, lo, 1.0 / h, 128), h, w


def test_pm_solve_is_the_float64_convolution():
    """The "pm" solve equals the float64 convolution to its fp32 output's
    rounding: an fp32 FFT is 3.0e-7 of max off it on this grid, and on the
    card (cuFFT) its rounding at a heavy body's cells leaves a self-force
    that drifts the momentum past tests/test_physics_validation.py's bound
    (tests/test_torch_scripts_cuda.py). The P³M solve (a taper) stays
    fp32."""
    rho, h, _ = _horizon_grid()
    eps2 = torch.tensor(4.0)
    want = _solve_float64(rho, h, eps2, 128)
    got = tpm._solve(rho, h, eps2, 128)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < 1e-7
    assert tpm._solve(rho, h, eps2, 128, rc=torch.tensor(8.0)).dtype == \
        torch.float32


def test_pm_net_force_of_a_heavy_core_vanishes():
    """sum m_i a_i over the scene, against sum |m_i a_i|: 0 for an exact
    mesh (the kernel is odd); 2.6e-3 and 2.3e-3 with the float64 solve
    (the fp32 CIC weights and gather), 1.2e-2 in x with an fp32 solve, the
    galaxy's core (m = 1.4e10) carrying most of it."""
    _, _, w = _horizon_grid()
    st = w.state
    acc = nt.pm_acc(st.pos, st.pos[:w.mass_len], w.gm, 2.0, grid=128)
    ma = st.mass.double()[:, None] * acc.double()
    net = (ma.sum(0) / ma.abs().sum()).abs()
    assert float(net.max()) < 5e-3, net
