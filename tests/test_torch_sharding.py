"""The port's ShardedWorld on CPU shards against nbody_tpu's on the
8-device virtual CPU mesh (tests/conftest.py): the layout and the padded
state bit for bit, the world stepped by each backend at the same D, and
copies of tests/test_sharding.py."""

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from helpers import random_particles
from torch_helpers import random_arrays, rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu.world import _create_padded_state
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh, shard_layout
from nbody_tpu_torch.parallel.sharding import padded_state

# tests/helpers.py's TINY tiles, on both sides
TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128)
# tests/test_torch_world.py:142: both sides run the same fp32 formulas and
# differ in the order of the force sums
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}


def _particles(n, seed=0, massless_frac=0.3):
    pos, vel, mass, radius = random_arrays(n, seed=seed,
                                           massless_frac=massless_frac)
    return nt.make_particles(pos, vel=vel, mass=mass, radius=radius)


def _cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


# --- layout and padded state against nbody_tpu ---

@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_shard_layout_matches_nbody_tpu(d):
    configs = [(TINY, TINY_JAX), (nt.SimConfig(), nb.SimConfig()),
               (nt.SimConfig(tile_targets=16, tile_sources=256),
                nb.SimConfig(tile_targets=16, tile_sources=256))]
    for n in (1, 7, 64, 96, 600, 5000, 70_000, 1 << 20):
        for mass_len in sorted({0, 1, n // 3, n // 2 + 1, n}):
            for cfg_t, cfg_j in configs:
                got = shard_layout(n, mass_len, cfg_t, d)
                assert got == jsh.shard_layout(n, mass_len, cfg_j, d), (n, mass_len)


@pytest.mark.parametrize("n,massless_frac,extra", [
    (1, 0.0, 7), (50, 0.3, 0), (96, 0.6, 32), (333, 1.0, 11), (400, 0.0, 100)])
def test_padded_state_matches_nbody_tpu(n, massless_frac, extra):
    p = _particles(n, seed=n, massless_frac=massless_frac)
    mass_len = int(torch.count_nonzero(p.mass > 0))
    n_pad = n + extra
    got, gm, valid = padded_state(p, mass_len, n_pad, 10.0)
    want, gm_j, valid_j = _create_padded_state(
        *(np.asarray(getattr(p, f)) for f in ("pos", "vel", "acc", "mass", "radius")),
        np.int32(mass_len), n_pad=n_pad, g=10.0)
    for name in ("pos", "vel", "acc", "mass", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(gm_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j)[:, 0])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_state_matches_nbody_tpu(d):
    p = _particles(96, seed=17)
    sw = ShardedWorld(p, _cpu_mesh(d), config=TINY, force_backend="torch")
    jw = jsh.ShardedWorld(random_particles(96, seed=17), jsh.make_mesh(d),
                          config=TINY_JAX, force_backend="jnp")
    for name in ("total_len", "mass_len", "src_len", "n_pad", "t_loc", "s_loc"):
        assert getattr(sw, name) == getattr(jw, name), name
    assert len(sw.pos) == d and all(x.shape == (sw.t_loc, 2) for x in sw.pos)
    for name in ("pos", "vel", "mass", "radius", "valid"):
        got = torch.cat(getattr(sw, name)).numpy()
        want = np.asarray(getattr(jw, name)).reshape(got.shape)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sw.gm_src.numpy(), np.asarray(jw.gm_src))


# --- the port against nbody_tpu at the same D ---

PAIRS = [("torch", "jnp"), ("cuda", "pallas"), ("cuda_ring", "pallas_ring")]


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
def test_sharded_matches_nbody_tpu(backend, jax_backend, integrator, d):
    """The same two-galaxy scene through both packages' ShardedWorld, 3
    substeps; on CPU shards "cuda" and "cuda_ring" walk the ring with the
    kernels' plain versions, as nbody_tpu's Pallas backends run interpreted."""
    sw = ShardedWorld(nt.make_galaxies(600, 2, seed=4), _cpu_mesh(d),
                      config=nt.SimConfig(integrator=integrator),
                      force_backend=backend)
    jw = jsh.ShardedWorld(nb.make_galaxies(600, 2, seed=4), jsh.make_mesh(d),
                          config=nb.SimConfig(integrator=integrator),
                          force_backend=jax_backend)
    sw.update(0.01, 3)
    jw.update(0.01, 3)
    got, want = sw.particles, jw.particles
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(got, name), getattr(want, name))
        assert err < tol, (name, err)


# --- copies of tests/test_sharding.py (the jnp cases on "torch") ---

@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_matches_single_device(n_devices):
    p = _particles(96, seed=17)
    sw = ShardedWorld(p, _cpu_mesh(n_devices), config=TINY, force_backend="torch")
    w = nt.create_world(p, config=TINY, device="cpu")
    sw.update(0.01, 5)
    w.update(0.01, 5, backend="torch")
    # same partition order on both sides -> rows comparable directly
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(sw.particles, name).numpy(),
                                   getattr(w.particles, name).numpy(),
                                   rtol=3e-4, atol=3e-3)


def test_sharded_galaxy_scene():
    p = nt.make_galaxies(400, 2, seed=11037)
    sw = ShardedWorld(p, _cpu_mesh(8), config=TINY, force_backend="torch")
    sw.update(0.01, 10)
    host = sw.particles
    assert torch.isfinite(host.pos).all()
    assert tuple(host.pos.shape) == (400, 2)


def test_sharded_substep_batching():
    p = _particles(64, seed=23)
    a = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="torch")
    b = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="torch")
    a.update(0.02, 4)
    for _ in range(4):
        b.update(0.02, 1)
    np.testing.assert_allclose(a.particles.pos.numpy(), b.particles.pos.numpy(),
                               rtol=1e-6)


def test_sharded_massless_rule_preserved():
    # sources rotated around the ring are exactly the massive prefix
    p = _particles(48, seed=29, massless_frac=0.6)
    sw = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="torch")
    assert sw.src_len % sw.n_devices == 0
    gm = sw.gm_src.numpy()
    assert gm.shape == (sw.src_len,)
    assert np.count_nonzero(gm) == sw.mass_len
    assert sum(sw.ring.n_real) == sw.mass_len


@pytest.mark.parametrize("name", ["jnp", "pallas_ring", "cuda_rng"])
def test_unknown_force_backend_raises(name):
    with pytest.raises(ValueError, match="unknown force_backend"):
        ShardedWorld(_particles(64, seed=32), _cpu_mesh(2), force_backend=name)


# --- the mesh backends, hooks, and the mesh ---

@pytest.mark.parametrize("name", ["pm", "p3m", "auto"])
def test_unported_force_backend_raises(name):
    """The backends that raised NotImplementedError before the sharded mesh
    solvers were ported now run on CPU shards: one substep against
    nbody_tpu's ShardedWorld at the same D ("auto" resolves to the direct
    backend at this size, "torch" for nbody_tpu's "jnp";
    tests/test_torch_sharded_mesh.py holds the mesh paths in depth)."""
    sw = ShardedWorld(_particles(64), _cpu_mesh(2), force_backend=name)
    jw = jsh.ShardedWorld(random_particles(64), jsh.make_mesh(2),
                          force_backend=name)
    assert sw.force_backend == {"jnp": "torch"}.get(jw.force_backend,
                                                     jw.force_backend)
    sw.update(0.01, 1)
    jw.update(0.01, 1)
    for field, tol in (("pos", 1e-6), ("vel", 5e-6), ("acc", 2e-5)):
        assert rel_err(getattr(sw.particles, field),
                       np.asarray(getattr(jw.particles, field))) < tol, field


def test_extra_force_raises():
    """A hook whose output is not (rows, 2) raises instead of
    broadcasting; a well-shaped one runs (tests/test_torch_hooks.py)."""
    sw = ShardedWorld(_particles(64), _cpu_mesh(2))
    with pytest.raises(ValueError, match="extra_force must return"):
        sw.update(0.01, 1, extra_force=lambda pos, vel: 0 * pos[:, :1])
    sw.update(0.01, 1, extra_force=lambda pos, vel: 0 * pos)


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedWorld(_particles(16))


def test_make_mesh_lists_devices():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4
    assert make_mesh(2, devices=mesh) == mesh[:2]
    with pytest.raises(ValueError):
        make_mesh(5, devices=mesh)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    with pytest.raises(ValueError):
        make_mesh(devices=["cpu", "meta"])


def test_cpu_sharded_world_defaults_and_makes_no_launch():
    before = (df.LAUNCHES, rf.LAUNCHES)
    sw = ShardedWorld(_particles(64), _cpu_mesh(3))
    assert sw.force_backend == "torch" and len(sw) == 64
    for backend in ("cuda", "cuda_ring"):
        ShardedWorld(_particles(64), _cpu_mesh(3), force_backend=backend).update(0.01, 2)
    assert (df.LAUNCHES, rf.LAUNCHES) == before


def test_update_zero_steps_is_identity():
    sw = ShardedWorld(_particles(40, seed=3), _cpu_mesh(4), config=TINY)
    before = sw.particles.pos.clone()
    sw.update(0.01, 0)
    assert torch.equal(sw.particles.pos, before)


def test_padding_rows_stay_zero():
    """Padding rows (mass 0, radius 1) are masked by valid: they never move
    and carry no acceleration."""
    sw = ShardedWorld(_particles(37, seed=5), _cpu_mesh(4), config=TINY,
                      force_backend="cuda_ring")
    assert sw.n_pad > sw.total_len
    sw.update(0.01, 3)
    for name in ("pos", "vel", "acc"):
        pad = torch.cat(getattr(sw, name))[sw.total_len:]
        assert torch.equal(pad, torch.zeros_like(pad)), name
