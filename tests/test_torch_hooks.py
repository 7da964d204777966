"""User force hooks (``extra_force``) and the rest of the top-level API of
the port, on the CPU: the cases of tests/test_extra_force.py that need no
autodiff or capture, each held against nbody_tpu on the same numpy inputs
with that file's tolerance; ``update_state``; and the names
``zeros_particles``, ``concat_particles``, ``acc_from_particles`` and
``resolve_backend``.

The hooks are written with operators only, so that the same function runs
on jax arrays and on torch tensors."""

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import random_arrays, rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh

DT = 0.01
# tests/helpers.py's TINY tiles, on both sides
TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128)
# tests/test_extra_force.py: max|d| / max|pos| between two direct-sum
# paths, and between p3m and the direct sum
TOL_DIRECT = 2e-5
TOL_P3M = 3e-3
TOL_SHARDED = 3e-5


def uniform(pos, vel):
    """A uniform field of -9.8 along both axes."""
    return 0.0 * pos - 9.8


def drag(pos, vel):
    return -2.0 * vel


def trap(pos, vel):
    return -4.0 * pos


def _tracer(vel=(0.0, 0.0), config=TINY):
    """One massless tracer: self-gravity is identically zero, so the hook's
    acceleration is the only dynamics."""
    p = nt.make_particles(np.zeros((1, 2), np.float32),
                          vel=np.asarray([vel], np.float32))
    return nt.create_world(p, config=config, device="cpu")


def _pos_scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


# --- tests/test_extra_force.py, on the port ---

@pytest.mark.parametrize("backend", ["torch", "pm", "p3m"])
def test_uniform_field_matches_euler_closed_form(backend):
    w = _tracer(config=nt.SimConfig(pm_grid=64))
    n = 50
    w.update(DT, n, backend=backend, extra_force=uniform)
    # v_k = k·a·dt, x_k = a·dt²·k(k+1)/2
    for axis in (0, 1):
        assert float(w.particles.vel[0, axis]) == pytest.approx(
            -9.8 * DT * n, rel=1e-5)
        assert float(w.particles.pos[0, axis]) == pytest.approx(
            -9.8 * DT * DT * n * (n + 1) / 2, rel=1e-4)


def test_drag_decays_velocity():
    w = _tracer(vel=(3.0, 0.0))
    w.update(DT, 100, extra_force=drag)
    assert float(w.particles.vel[0, 0]) == pytest.approx(
        3.0 * (1.0 - 2.0 * DT) ** 100, rel=1e-4)
    assert abs(float(w.particles.vel[0, 1])) == 0.0


@pytest.mark.parametrize("backend,jax_backend,tol", [
    ("torch", "jnp", TOL_DIRECT), ("torch", "pallas", TOL_DIRECT),
    ("p3m", "p3m", TOL_P3M), ("pm", "pm", TOL_DIRECT)])
def test_composes_with_gravity_as_nbody_tpu(backend, jax_backend, tol):
    """The hook adds to (not replaces) self-gravity, on every CPU backend
    of the port, as on nbody_tpu's."""
    scene_t = nt.make_galaxies(250, 1, seed=3)
    scene_j = nb.make_galaxies(250, 1, seed=3)
    base = nt.create_world(scene_t, config=TINY, device="cpu")
    base.update(DT, 5)
    w = nt.create_world(scene_t, config=TINY, device="cpu")
    w.update(DT, 5, backend=backend, extra_force=uniform)
    got = w.particles.pos.numpy()
    jw = nb.create_world(scene_j, config=TINY_JAX)
    jw.update(DT, 5, backend=jax_backend, extra_force=uniform)
    assert _pos_scaled_err(got, jw.particles.pos) < tol
    if backend == "torch":
        # the whole system drifted by a·dt²·k(k+1)/2 on top of gravity
        shift = -9.8 * DT * DT * 5 * 6 / 2
        delta = got.mean(axis=0) - base.particles.pos.numpy().mean(axis=0)
        np.testing.assert_allclose(delta, shift, atol=3e-4)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_hook_sees_entry_velocity_as_nbody_tpu(integrator):
    """A velocity hook under each integrator: every stage sees the
    substep-entry velocity, as in nbody_tpu."""
    cfg = dict(tile_targets=8, tile_sources=128, integrator=integrator)
    w = nt.create_world(nt.make_galaxies(300, 2, seed=5),
                        config=nt.SimConfig(**cfg), device="cpu")
    jw = nb.create_world(nb.make_galaxies(300, 2, seed=5),
                         config=nb.SimConfig(**cfg))
    hook = lambda pos, vel: -0.1 * vel  # noqa: E731
    w.update(DT, 4, extra_force=hook)
    jw.update(DT, 4, backend="jnp", extra_force=hook)
    for name in ("pos", "vel"):
        assert rel_err(getattr(w.particles, name),
                       getattr(jw.particles, name)) < TOL_DIRECT, name


def test_applies_to_massless_rows():
    """Tracers feel the field: in an all-massless world every row's vy is
    exactly the accumulated field. The port's World has no padding rows to
    mask."""
    p = nt.make_particles(np.random.default_rng(0)
                          .uniform(-5, 5, (16, 2)).astype(np.float32))
    w = nt.create_world(p, config=TINY, device="cpu")
    assert w.state.n == 16
    w.update(DT, 3, extra_force=uniform)
    want = nb.create_world(nb.make_particles(p.pos.numpy()), config=TINY_JAX)
    want.update(DT, 3, backend="jnp", extra_force=uniform)
    np.testing.assert_allclose(w.particles.vel.numpy(), -9.8 * DT * 3,
                               rtol=1e-5)
    np.testing.assert_array_equal(w.particles.vel.numpy(),
                                  np.asarray(want.particles.vel))


def test_massless_rows_of_a_galaxy_get_the_hook():
    """In a galaxy scene the massless rows (past mass_len) get gravity plus
    the hook: a zero hook and a uniform one differ by the field exactly as
    in nbody_tpu."""
    scene = nt.make_galaxies(250, 1, seed=3)
    a = nt.create_world(scene, device="cpu")
    b = nt.create_world(scene, device="cpu")
    a.update(DT, 1, extra_force=lambda pos, vel: 0.0 * pos)
    b.update(DT, 1, extra_force=uniform)
    tracers = slice(a.mass_len, None)
    vel = b.particles.vel[tracers].numpy()
    dv = vel - a.particles.vel[tracers].numpy()
    # the difference of two rounded velocities: a few ulp of max|v|
    np.testing.assert_allclose(dv, -9.8 * DT,
                               atol=4 * np.spacing(np.abs(vel).max()))


def test_leapfrog_with_position_hook():
    """A conservative hook under the symplectic integrator: harmonic trap,
    energy bounded over many periods."""
    cfg = nt.SimConfig(tile_targets=8, tile_sources=128, integrator="leapfrog")
    w = _tracer(vel=(0.0, 1.0), config=cfg)
    w.update(DT, 2000, extra_force=trap)
    x, v = w.particles.pos.numpy()[0], w.particles.vel.numpy()[0]
    e = 0.5 * float(v @ v) + 2.0 * float(x @ x)
    assert e == pytest.approx(0.5, rel=2e-3)


@pytest.mark.parametrize("force_backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_hook_matches_single_device(force_backend):
    """ShardedWorld.update(extra_force=...) composes the field per shard:
    four CPU shards against the single-device World (port) and nbody_tpu's
    World under the same hook; then an unhooked update still runs."""
    scene_t = nt.make_galaxies(256, 1, seed=9)
    single = nt.create_world(scene_t, config=TINY, device="cpu")
    single.update(DT, 4, extra_force=uniform)
    jw = nb.create_world(nb.make_galaxies(256, 1, seed=9), config=TINY_JAX)
    jw.update(DT, 4, backend="jnp", extra_force=uniform)
    sw = ShardedWorld(scene_t, _cpu_mesh(4), config=TINY,
                      force_backend=force_backend)
    sw.update(DT, 4, extra_force=uniform)
    got = sw.particles.pos.numpy()
    assert _pos_scaled_err(got, single.particles.pos) < TOL_SHARDED
    assert _pos_scaled_err(got, jw.particles.pos) < TOL_SHARDED
    sw.update(DT, 1)
    assert torch.isfinite(sw.particles.pos).all()


@pytest.mark.parametrize("integrator", ["euler", "yoshida4"])
def test_sharded_hook_matches_nbody_tpu_sharded(integrator):
    """The port's hooked "cuda_ring" on four CPU shards against nbody_tpu's
    hooked "pallas_ring" on four (interpreted), velocity hook."""
    cfg = dict(tile_targets=8, tile_sources=128, integrator=integrator)
    hook = lambda pos, vel: -0.1 * vel  # noqa: E731
    sw = ShardedWorld(nt.make_galaxies(256, 2, seed=9), _cpu_mesh(4),
                      config=nt.SimConfig(**cfg), force_backend="cuda_ring")
    jw = jsh.ShardedWorld(nb.make_galaxies(256, 2, seed=9), jsh.make_mesh(4),
                          config=nb.SimConfig(**cfg),
                          force_backend="pallas_ring")
    sw.update(DT, 3, extra_force=hook)
    jw.update(DT, 3, extra_force=hook)
    for name in ("pos", "vel"):
        assert rel_err(getattr(sw.particles, name),
                       getattr(jw.particles, name)) < TOL_SHARDED, name


def test_sharded_padding_rows_stay_zero_under_a_hook():
    """The hook's term is masked by ``valid``: padding rows of a sharded
    world stay exactly zero under a field that is nonzero everywhere."""
    sw = ShardedWorld(nt.make_galaxies(200, 1, seed=2), _cpu_mesh(4),
                      config=TINY, force_backend="cuda_ring")
    assert sw.n_pad > sw.total_len
    sw.update(DT, 3, extra_force=uniform)
    for name in ("pos", "vel", "acc"):
        pad = torch.cat(getattr(sw, name))[sw.total_len:]
        assert torch.equal(pad, torch.zeros_like(pad)), name


def test_hooked_cpu_paths_make_no_launch():
    before = (df.LAUNCHES, rf.LAUNCHES)
    sw = ShardedWorld(nt.make_galaxies(200, 1, seed=2), _cpu_mesh(2),
                      config=TINY, force_backend="cuda_ring")
    sw.update(DT, 2, extra_force=drag)
    assert (df.LAUNCHES, rf.LAUNCHES) == before


@pytest.mark.parametrize("bad", [lambda p, v: p[:, :1], lambda p, v: 5.0,
                                 lambda p, v: torch.zeros(())])
def test_wrong_shape_hook_raises(bad):
    """A (N, 1) or scalar return would broadcast silently: every entry
    path rejects it."""
    w = _tracer()
    with pytest.raises(ValueError, match="extra_force must return"):
        w.update(DT, extra_force=bad)
    with pytest.raises(ValueError, match="extra_force must return"):
        w.update_adaptive(0.05, extra_force=bad)
    sw = ShardedWorld(nt.make_galaxies(256, 1, seed=9), _cpu_mesh(2),
                      config=TINY)
    with pytest.raises(ValueError, match="extra_force must return"):
        sw.update(DT, extra_force=bad)


def test_checked_extra_acc_casts_to_fp32_on_pos_device():
    pos = torch.zeros((3, 2))
    out = nt.forces.checked_extra_acc(
        lambda p, v: np.ones((3, 2), np.float64), pos, pos)
    assert out.dtype == torch.float32 and out.device == pos.device
    assert torch.equal(out, torch.ones((3, 2)))


# --- update_state, the functional n-substep call ---

@pytest.mark.parametrize("backend", ["torch", "pm", "p3m"])
def test_update_state_is_world_update(backend):
    """update_state on (state, gm, config) gives World.update's bits, with
    and without a hook; "p3m" rebins every p3m_rebin_interval substeps."""
    cfg = nt.SimConfig(pm_grid=64, p3m_rebin_interval=2)
    scene = nt.make_galaxies(300, 2, seed=6)
    for hook in (None, drag):
        w = nt.create_world(scene, config=cfg, device="cpu")
        st0, gm = w.state, w.gm
        st = nt.update_state(st0, gm, DT, 5, config=cfg, backend=backend,
                             extra_force=hook)
        w.update(DT, 5, backend=backend, extra_force=hook)
        for name in ("pos", "vel", "acc"):
            assert torch.equal(getattr(st, name), getattr(w.state, name))


def test_update_state_matches_nbody_tpu():
    scene_t = nt.make_galaxies(300, 2, seed=6)
    w = nt.create_world(scene_t, device="cpu")
    st = nt.update_state(w.state, w.gm, DT, 4, config=nt.SimConfig(),
                         backend="torch", extra_force=drag)
    jw = nb.create_world(nb.make_galaxies(300, 2, seed=6))
    jst = nb.update_state(jw.state, jw.gm, jw.valid, np.float32(DT),
                          np.int32(4), src_len=jw.mass_len,
                          config=nb.SimConfig(), backend="jnp",
                          extra_force=drag)
    assert rel_err(st.pos, np.asarray(jst.pos)[:w.total_len]) < TOL_DIRECT


def test_update_state_refuses_cuda_on_cpu_tensors():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=1), device="cpu")
    with pytest.raises(ValueError, match="needs a world on a CUDA device"):
        nt.update_state(w.state, w.gm, DT, 1, backend="cuda")
    with pytest.raises(ValueError, match="backend must be one of"):
        nt.update_state(w.state, w.gm, DT, 1, backend="jnp")


# --- the new top-level names ---

def test_top_level_names_match_nbody_tpu():
    for name in ("zeros_particles", "concat_particles", "acc_from_particles",
                 "resolve_backend", "update_state"):
        assert name in nt.__all__ and hasattr(nt, name), name
    for name in ("make_galaxies_device",):
        assert name in nt.__all__ and hasattr(nt, name), name
    missing = set(nb.__all__) - set(nt.__all__)
    assert missing == set(), missing
    assert all(hasattr(nt, name) for name in nt.__all__)


def test_zeros_and_concat_particles_match_nbody_tpu():
    z = nt.zeros_particles(3)
    jz = nb.zeros_particles(3)
    for name in ("pos", "vel", "acc", "mass", "radius"):
        np.testing.assert_array_equal(getattr(z, name).numpy(),
                                      np.asarray(getattr(jz, name)))
        assert getattr(z, name).dtype == torch.float32
    pos, vel, mass, radius = random_arrays(5, seed=1)
    a = nt.make_particles(pos, vel=vel, mass=mass, radius=radius)
    ja = nb.make_particles(pos, vel=vel, mass=mass, radius=radius)
    both, jboth = nt.concat_particles(a, z), nb.concat_particles(ja, jz)
    assert both.n == 8
    for name in ("pos", "vel", "acc", "mass", "radius"):
        np.testing.assert_array_equal(getattr(both, name).numpy(),
                                      np.asarray(getattr(jboth, name)))


@pytest.mark.parametrize("precise", [False, True])
def test_acc_from_particles_matches_nbody_tpu(precise):
    pos, _, mass, radius = random_arrays(300, seed=4)
    order, mass_len = nt.partition_massive_first(mass)
    pos, mass, radius = (x[order.numpy()] for x in (pos, mass, radius))
    got = nt.acc_from_particles(torch.from_numpy(pos),
                                torch.from_numpy(radius),
                                torch.from_numpy(mass), mass_len,
                                precise=precise)
    want = nb.acc_from_particles(pos, radius, mass, mass_len, precise=precise)
    # tests/test_torch_forces.py's bound for the direct sum
    assert rel_err(got, np.asarray(want)) < 5e-6


@pytest.mark.parametrize("n", [65536, 1 << 20])
def test_resolve_backend_is_exported(n):
    from nbody_tpu.world import resolve_backend

    assert nt.resolve_backend("auto", n, n // 2) == {"jnp": "torch"}.get(
        resolve_backend("auto", n, n // 2), resolve_backend("auto", n, n // 2))
    assert nt.resolve_backend("pm", n, 0) == "pm"
