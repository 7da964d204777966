"""The port's World on the CPU ("torch" backend): copies of nbody_tpu's world
tests, parity with nbody_tpu.World on its "jnp" and "pallas" (interpret)
backends, the reference binary's goldens, and the interop round trip."""

import os

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import DATA, REF_TRAJ, load_hex_dump, random_arrays, rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu_torch import interop
from nbody_tpu_torch.models import make_galaxies_libc
from nbody_tpu_torch.models.galaxy_ref import available as libm_available
from nbody_tpu_torch.ops import direct_forces as df

needs_libm = pytest.mark.skipif(
    not libm_available(), reason="oracle needs the platform libm via ctypes")


def _particles(n, seed=0):
    pos, vel, mass, radius = random_arrays(n, seed=seed)
    return nt.make_particles(pos, vel=vel, mass=mass, radius=radius)


def _world(p, **cfg):
    return nt.create_world(p, config=nt.SimConfig(**cfg), device="cpu")


# --- copies of tests/test_world.py and tests/test_edge_cases.py ---

def test_partition_is_stable():
    order, _ = nt.partition_massive_first(np.array([1.0, 0.0, 2.0, 0.0, 3.0]))
    assert order.tolist() == [0, 2, 4, 1, 3]


@pytest.mark.parametrize("masses", [[], [0.0], [1.0], [0.0, 1.0, 0.0, 2.0],
                                    [1.0, 0.0, 2.0, 0.0, 3.0]])
def test_partition_matches_nbody_tpu(masses):
    m = np.array(masses, np.float32)
    order, mass_len = nt.partition_massive_first(m)
    want_order, want_len = nb.partition_massive_first(m)
    assert mass_len == want_len
    assert order.tolist() == want_order.tolist()


def test_update_zero_steps_is_identity():
    w = _world(_particles(16))
    before = w.particles.pos.clone()
    w.update(0.01, 0)
    assert torch.equal(w.particles.pos, before)


def test_n_substeps_equals_repeated_single_steps():
    # Quirk #7: update(dt, n) == n * update(dt, 1), exactly.
    p = _particles(24, seed=7)
    w1, w2 = _world(p), _world(p)
    w1.update(0.01, 5)
    for _ in range(5):
        w2.update(0.01, 1)
    assert torch.equal(w1.particles.pos, w2.particles.pos)
    assert torch.equal(w1.particles.vel, w2.particles.vel)


def test_massless_particles_move_but_exert_nothing():
    p = nt.make_particles(
        np.array([[0.0, 0.0], [10.0, 0.0]], np.float32),
        mass=np.array([1000.0, 0.0], np.float32),
        radius=np.array([2.0, 0.5], np.float32),
    )
    w = _world(p)
    w.update(0.01, 1)
    host = w.particles
    massive = host.mass > 0
    assert torch.equal(host.acc[massive], torch.zeros_like(host.acc[massive]))
    assert host.acc[~massive][0, 0] < 0


def test_all_massless_zero_radius_world_drifts():
    """mass_len == 0 still steps: pure drift, reversible by negating dt."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(64, 2)).astype(np.float32)
    vel = rng.normal(size=(64, 2)).astype(np.float32)
    p = nt.make_particles(pos, vel=vel, radius=np.zeros(64, np.float32))
    w = _world(p)
    assert w.mass_len == 0 and w.gm.shape == (0,)
    w.update(0.01, 5)
    w.update(-0.01, 5)
    got = w.particles.pos.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pos, atol=2e-6)
    assert torch.equal(w.particles.acc, torch.zeros(64, 2))


def test_world_layout():
    p = _particles(37)
    w = _world(p)
    assert len(w) == w.total_len == w.state.n == 37   # no padding rows
    m = w.particles.mass
    assert (m[:w.mass_len] > 0).all() and (m[w.mass_len:] == 0).all()
    torch.testing.assert_close(w.gm, 10.0 * m[:w.mass_len], rtol=0, atol=0)
    assert w.default_backend == "torch"


# --- errors ---

def test_cuda_backend_on_cpu_world_raises():
    w = _world(_particles(16))
    with pytest.raises(ValueError, match="CUDA device"):
        w.update(0.01, 1, backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        w.update_gpu(0.01, 1)


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        _world(_particles(8)).update(0.01, 1, backend="jnp")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        nt.create_world(_particles(8), device="cuda")


def test_cpu_world_makes_no_kernel_launch():
    before = df.LAUNCHES
    _world(_particles(16)).update(0.01, 3)
    assert df.LAUNCHES == before


# --- parity with nbody_tpu.World ---

# Tolerances (max|Δ|/max|ref| over all particles after 5 substeps at N=600):
# both sides run the same fp32 formulas; they differ in the order of the
# S-term force sums, by ~1e-7 of max|a| per evaluation, carried through up
# to 15 evaluations. Measured: pos <= 1.2e-7, vel <= 2.2e-7, acc <= 7.6e-7.
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_world_matches_nbody_tpu(integrator, backend):
    p_t = nt.make_galaxies(600, 2, seed=4)
    p_j = nb.make_galaxies(600, 2, seed=4)
    w_t = nt.create_world(p_t, config=nt.SimConfig(integrator=integrator),
                          device="cpu")
    w_j = nb.create_world(p_j, config=nb.SimConfig(integrator=integrator))
    assert w_t.mass_len == w_j.mass_len
    w_t.update(0.01, 5)
    w_j.update(0.01, 5, backend=backend)
    got, want = w_t.particles, w_j.particles
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(got, name), getattr(want, name))
        assert err < tol, (name, err)


def test_yoshida4_stage_dt_is_rounded_in_fp32():
    """yoshida4's stage dt w * dt is formed in fp32, as the JAX step forms
    it. Rows whose positions differ bit for bit from nbody_tpu's jnp World
    after 5 substeps at N=600: 162 with the stage dt rounded in float64,
    111 with it rounded in fp32 (the rest is the order of the force sums,
    which the max error of test_world_matches_nbody_tpu bounds)."""
    cfg = dict(integrator="yoshida4")
    w_t = nt.create_world(nt.make_galaxies(600, 2, seed=4),
                          config=nt.SimConfig(**cfg), device="cpu")
    w_j = nb.create_world(nb.make_galaxies(600, 2, seed=4),
                          config=nb.SimConfig(**cfg))
    w_t.update(0.01, 5, backend="torch")
    w_j.update(0.01, 5, backend="jnp")
    got, want = w_t.particles.pos.numpy(), np.asarray(w_j.particles.pos)
    differ = int((got != want).any(axis=1).sum())
    assert differ <= 120, differ
    assert rel_err(got, want) < WORLD_TOL["pos"]


# --- default_backend and "auto" (nbody_tpu/world.py:81-100, :595-599) ---

@pytest.mark.parametrize("n", [65536, 1 << 20])
def test_auto_backend_resolves_as_nbody_tpu(n):
    """At N=65536 the scene has 2.2e9 pairs (direct sum), at N=1M 5.5e11
    (p3m); nbody_tpu's "jnp" is the CPU world's "torch"."""
    from nbody_tpu.world import resolve_backend

    scene = nt.make_galaxies(n, 2, seed=11037)
    w = nt.create_world(scene, default_backend="auto", device="cpu")
    want = resolve_backend("auto", n, w.mass_len)
    assert w.mass_len == int(np.count_nonzero(scene.mass.numpy() > 0))
    assert w.default_backend == {"jnp": "torch"}.get(want, want)
    assert w.default_backend == ("torch" if n == 65536 else "p3m")


def test_default_backend_argument():
    p = _particles(64)
    assert nt.create_world(p, device="cpu").default_backend == "torch"
    for backend in ("torch", "pm", "p3m"):
        w = nt.World(p, default_backend=backend, device="cpu")
        assert w.default_backend == backend
    with pytest.raises(ValueError, match="backend"):
        nt.create_world(p, default_backend="jnp", device="cpu")
    # "auto" is also a per-call backend; at 64 particles it is the direct sum
    w1, w2 = _world(p), _world(p)
    w1.update(0.01, 2, backend="auto")
    w2.update(0.01, 2, backend="torch")
    assert torch.equal(w1.particles.pos, w2.particles.pos)


# --- the reference binary's goldens (tests/test_physics_validation.py:256-291) ---

def _bitexact_world_and_golden(steps):
    ic = make_galaxies_libc(2000, 2, seed=11037)
    perm, _ = nt.partition_massive_first(ic.mass)
    golden = load_hex_dump(os.path.join(DATA, REF_TRAJ.format(steps=steps)))
    return _world(ic, precise=True), golden[perm.numpy()]


def _golden_errors(w, golden):
    got = w.particles
    np.testing.assert_array_equal(got.mass.numpy(), golden[:, 4])
    np.testing.assert_array_equal(got.radius.numpy(), golden[:, 5])
    dpos = np.abs(got.pos.numpy() - golden[:, :2]).max() / np.abs(golden[:, :2]).max()
    dvel = np.abs(got.vel.numpy() - golden[:, 2:4]).max() / np.abs(golden[:, 2:4]).max()
    return dpos, dvel


@needs_libm
def test_reference_binary_pointwise_20_steps():
    """The bounds of test_physics_validation.py: the reference agrees with
    itself (AVX vs scalar build) to 6.3e-8 / 4.5e-7 here."""
    w, golden = _bitexact_world_and_golden(20)
    w.update_cpu(0.01, 20)
    dpos, dvel = _golden_errors(w, golden)
    assert dpos < 5e-7, dpos
    assert dvel < 5e-6, dvel


@needs_libm
def test_reference_binary_pointwise_100_steps():
    """The reference's own build-to-build spread at 100 steps is 1.4e-4
    position / 2.8e-2 velocity."""
    w, golden = _bitexact_world_and_golden(100)
    w.update_cpu(0.01, 100)
    dpos, dvel = _golden_errors(w, golden)
    assert dpos < 1.5e-4, dpos
    assert dvel < 3e-2, dvel


# --- interop ---

def test_interop_round_trip_from_nbody_tpu():
    p_j = nb.make_galaxies(300, 1, seed=9)
    host = p_j.to_host()
    p_t = interop.particles_from_numpy(**vars(host), device="cpu")
    for name in interop.FIELDS:
        t = getattr(p_t, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(host, name))
    back = nb.make_particles(**interop.to_numpy(p_t))
    for name in interop.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      getattr(host, name))


def test_interop_state_carries_across():
    """A JAX world stepped, handed over, stepped on in the port, matches a
    JAX world stepped throughout."""
    p_j = nb.make_galaxies(300, 1, seed=10)
    w_a = nb.create_world(p_j, config=nb.SimConfig(precise=True))
    w_a.update(0.01, 3, backend="jnp")
    w_t = nt.create_world(
        interop.particles_from_numpy(**vars(w_a.particles), device="cpu"),
        config=nt.SimConfig(precise=True), device="cpu")
    w_t.update(0.01, 3)
    w_a.update(0.01, 3, backend="jnp")
    assert rel_err(w_t.particles.pos, w_a.particles.pos) < WORLD_TOL["pos"]
