"""The port's diagnostics (``nbody_tpu_torch.diagnostics``) and adaptive dt
(``World.update_adaptive``, ``ShardedWorld.update_adaptive``) on the CPU:
every case of tests/test_diagnostics.py and the cases of
tests/test_adaptive.py that need neither collision merging nor the sharded
mesh solvers, each held against nbody_tpu on the same numpy inputs with
those files' tolerances. Adaptive substep counts must equal nbody_tpu's."""

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu import diagnostics as jd
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu_torch import diagnostics as td
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh

TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128)
G = 10.0


def _both(pos, vel=None, mass=None, radius=None):
    """The same particles in both packages."""
    arrays = [None if a is None else np.asarray(a, np.float32)
              for a in (vel, mass, radius)]
    return (nt.make_particles(np.asarray(pos, np.float32), *arrays),
            nb.make_particles(np.asarray(pos, np.float32), *arrays))


def two_body():
    return _both([[0.0, 0.0], [3.0, 4.0]], vel=[[1.0, 0.0], [0.0, 2.0]],
                 mass=[2.0, 5.0], radius=[1.0, 2.0])


def _cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- tests/test_diagnostics.py, on the port and against nbody_tpu ---

def test_momentum_and_com_golden():
    p, jp = two_body()
    np.testing.assert_allclose(td.total_momentum(p).numpy(), [2.0, 10.0],
                               rtol=1e-6)
    np.testing.assert_allclose(td.center_of_mass(p).numpy(),
                               [15.0 / 7.0, 20.0 / 7.0], rtol=1e-6)
    np.testing.assert_allclose(td.total_momentum(p).numpy(),
                               np.asarray(jd.total_momentum(jp)), rtol=1e-6)
    np.testing.assert_allclose(td.center_of_mass(p).numpy(),
                               np.asarray(jd.center_of_mass(jp)), rtol=1e-6)


def test_kinetic_golden():
    p, jp = two_body()
    assert float(td.kinetic_energy(p)) == pytest.approx(11.0, rel=1e-6)
    assert float(td.kinetic_energy(p)) == pytest.approx(
        float(jd.kinetic_energy(jp)), rel=1e-6)


@pytest.mark.parametrize("chunk", [1, 2, None])
def test_potential_golden(chunk):
    p, jp = two_body()
    want = -G / 2 * (10.0 / np.sqrt(26.0) + 10.0 / np.sqrt(27.0))
    got = float(td.potential_energy(p, mass_len=2, chunk=chunk))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(float(jd.potential_energy(jp, 2, chunk=2)),
                                rel=1e-6)


def test_self_term_excluded():
    p, _ = _both(np.zeros((1, 2)), mass=[7.0], radius=[1.0])
    assert float(td.potential_energy(p, mass_len=1, chunk=1)) == 0.0


def test_tracers_contribute_zero_potential():
    p, _ = two_body()
    tr, _ = _both([[10.0, 10.0]], mass=[0.0], radius=[0.5])
    both = nt.concat_particles(p, tr)
    a = float(td.potential_energy(p, mass_len=2, chunk=2))
    b = float(td.potential_energy(both, mass_len=2, chunk=3))
    assert a == pytest.approx(b, rel=1e-6)


def test_summary_and_conservation_over_run():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=11), config=TINY,
                        device="cpu")
    s0 = td.summary(w)
    e0 = s0["kinetic_energy"] + s0["potential_energy"]
    w.update(0.005, 200)
    s1 = td.summary(w)
    e1 = s1["kinetic_energy"] + s1["potential_energy"]
    assert abs(e1 - e0) / abs(e0) < 0.05
    assert s1["n"] == 200 and s1["mass_len"] == w.mass_len
    assert float(td.total_energy(w.state, w.mass_len)) == pytest.approx(
        e1, rel=1e-6)


def test_summary_matches_nbody_tpu():
    """summary() of both packages' worlds after the same 20 substeps."""
    w = nt.create_world(nt.make_galaxies(400, 2, seed=11), config=TINY,
                        device="cpu")
    jw = nb.create_world(nb.make_galaxies(400, 2, seed=11), config=TINY_JAX)
    w.update(0.005, 20)
    jw.update(0.005, 20, backend="jnp")
    got, want = td.summary(w), jd.summary(jw)
    assert set(got) == set(want)
    assert (got["n"], got["mass_len"]) == (want["n"], want["mass_len"])
    for key in ("kinetic_energy", "potential_energy", "angular_momentum",
                "suggested_dt"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for key in ("momentum", "center_of_mass"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5 * max(map(abs, want[key])))


def test_angular_momentum_golden():
    p, jp = two_body()
    assert float(td.angular_momentum(p)) == pytest.approx(30.0, rel=1e-6)
    assert float(td.angular_momentum(p)) == float(jd.angular_momentum(jp))


def test_angular_momentum_drift_bounded_over_run():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=11), config=TINY,
                        device="cpu")
    l0 = float(td.angular_momentum(w.state))
    w.update(0.005, 200)
    l1 = float(td.angular_momentum(w.state))
    assert abs(l1 - l0) / max(abs(l0), 1e-6) < 0.05


def test_suggest_dt_scaling_and_edge_cases():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=3), config=TINY,
                        device="cpu")
    w.update(0.001, 1)
    dt1 = float(td.suggest_dt(w.state))
    dt2 = float(td.suggest_dt(w.state, eta=0.2))
    assert 0 < dt1 < np.inf
    assert dt2 == pytest.approx(2 * dt1, rel=1e-6)
    drifters, _ = _both([[0.0, 0.0], [1.0, 0.0]], mass=np.zeros(2))
    assert np.isinf(float(td.suggest_dt(drifters)))


@pytest.mark.parametrize("eta", [0.05, 0.1, 0.3])
def test_criterion_equals_nbody_tpus_bit_for_bit(eta):
    """The criterion takes three square roots a row and a min: with the
    port's correctly rounded CPU sqrt it equals nbody_tpu's bit for bit on
    the same accelerations, and so does each clipped dt."""
    rng = np.random.default_rng(int(eta * 100))
    acc = (rng.normal(size=(4096, 2)) * 10.0 ** rng.uniform(-3, 3, (4096, 1))
           ).astype(np.float32)
    acc[::7] = 0.0
    radius = rng.uniform(0.0, 9.5, 4096).astype(np.float32)
    got = td.criterion_dt(torch.from_numpy(acc), torch.from_numpy(radius), eta)
    want = jd.criterion_dt(jnp.asarray(acc), jnp.asarray(radius),
                           jnp.float32(eta))
    assert got.item() == float(want)
    for t in (0.0, 0.0999, 0.25):
        kw = dict(eta=eta, dt_min=1e-5, dt_max=0.02, t=np.float32(t),
                  t_span=0.1)
        got = td.next_adaptive_dt(torch.from_numpy(acc),
                                  torch.from_numpy(radius), **{
                                      **kw, "t": torch.tensor(np.float32(t))})
        want = jd.next_adaptive_dt(
            jnp.asarray(acc), jnp.asarray(radius),
            **{k: jnp.float32(v) for k, v in kw.items()})
        assert got.item() == float(want), t


def test_potential_energy_pm_tracks_exact_on_galaxy():
    w = nt.create_world(nt.make_galaxies(2000, 2, seed=3), device="cpu")
    ue = float(td.potential_energy(w.state, w.mass_len))
    up = float(td.potential_energy_pm(w.state, w.mass_len, grid=256))
    assert abs(up - ue) / abs(ue) < 0.02, (up, ue)
    jw = nb.create_world(nb.make_galaxies(2000, 2, seed=3))
    st = jw.state.slice_to(jw.total_len)
    assert ue == pytest.approx(float(jd.potential_energy(st, jw.mass_len)),
                               rel=1e-5)
    # against nbody_tpu's mesh estimate, the bound of the estimate itself:
    # each particle's mesh potential cancels against its self-term, sums
    # of ~1.3e21 leaving ~2.5e16, so the fp32 order of either package's
    # operations moves U by up to ~1% (0.6% here)
    up_j = float(jd.potential_energy_pm(st, jw.mass_len, grid=256))
    assert abs(up - up_j) / abs(up_j) < 0.02, (up, up_j)


def test_potential_energy_pm_self_term_removed():
    p, _ = _both([[3.7, -1.2]], mass=[1e6])
    u = float(td.potential_energy_pm(p, 1, grid=64, softening=2.0))
    assert abs(u) < 1e-3 * 0.5 * 10.0 * 1e12, u


def test_potential_energy_pm_two_body_analytic():
    m, d, eps = 1e5, 300.0, 2.0
    p, jp = _both([[-d / 2, 0.0], [d / 2, 0.0]], mass=[m, m])
    u = float(td.potential_energy_pm(p, 2, grid=256, softening=eps))
    expect = -10.0 * m * m / np.sqrt(d * d + eps * eps)
    assert abs(u - expect) / abs(expect) < 0.02, (u, expect)
    assert u == pytest.approx(
        float(jd.potential_energy_pm(jp, 2, grid=256, softening=eps)),
        rel=1e-5)


def test_potential_energy_pm_without_mass_is_zero():
    p, _ = _both(np.ones((3, 2)))
    assert float(td.potential_energy_pm(p, 0, grid=64)) == 0.0


# --- the capture helpers (their caller, record_observables, is A5) ---

@pytest.mark.parametrize("energy", [None, "exact", "pm"])
def test_observables_capture_matches_nbody_tpu(energy):
    w = nt.create_world(nt.make_galaxies(300, 2, seed=8), device="cpu")
    jw = nb.create_world(nb.make_galaxies(300, 2, seed=8))
    got = td.observables_capture(w.mass_len, energy=energy, pm_grid=64)(
        w.state, w.gm)
    want = jd.observables_capture(jw.mass_len, energy=energy, pm_grid=64)(
        jw.state.slice_to(jw.total_len), jw.gm)
    assert set(got) == set(want)
    for key, value in want.items():
        # the mesh estimate: test_potential_energy_pm_tracks_exact_on_galaxy
        rtol = 0.02 if (energy, key) == ("pm", "potential") else 1e-5
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   rtol=rtol, atol=1e-6 * np.abs(value).max())


def test_observables_capture_rejects_unknown_energy():
    with pytest.raises(ValueError, match="energy must be"):
        td.observables_capture(4, energy="mesh")


def test_check_observables_args():
    td.check_observables_args(None, "pm", {"pm_grid": 64})
    td.check_observables_args(lambda st, gm: st.pos, "exact", {})
    with pytest.raises(ValueError, match="custom capture"):
        td.check_observables_args(lambda st, gm: st.pos, "pm", {})
    with pytest.raises(ValueError, match="custom capture"):
        td.check_observables_args(lambda st, gm: st.pos, "exact",
                                  {"pe_chunk": 8})


def test_observables_series_out_matches_nbody_tpu():
    series = {"kinetic": torch.arange(3.0), "momentum": torch.ones((3, 2))}
    got = td.observables_series_out(series, 3, 5, 0.01)
    want = jd.observables_series_out(
        {k: jnp.asarray(v.numpy()) for k, v in series.items()}, 3, 5, 0.01)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    out = td.observables_series_out(torch.zeros(3), 3, 1, 0.1)
    assert set(out) == {"capture", "time"}
    with pytest.raises(ValueError, match="'time' key"):
        td.observables_series_out({"time": torch.zeros(3)}, 3, 1, 0.1)


# --- tests/test_adaptive.py, on the port and against nbody_tpu ---

def _adaptive_pair(particles, t_span, *, backend="torch", jax_backend="jnp",
                   config=None, **kw):
    """Both packages' worlds through update_adaptive: (port world, port k,
    nbody_tpu world, nbody_tpu k)."""
    cfg = config or {}
    w = nt.create_world(particles[0], config=nt.SimConfig(**cfg),
                        device="cpu")
    jw = nb.create_world(particles[1], config=nb.SimConfig(**cfg))
    k = w.update_adaptive(t_span, backend=backend, **kw)
    jk = jw.update_adaptive(t_span, backend=jax_backend, **kw)
    return w, k, jw, jk


def test_force_free_world_takes_dt_max_steps():
    p = _both(np.zeros((1, 2)), vel=[[2.0, -1.0]])
    w, k, jw, jk = _adaptive_pair(p, 1.0, dt_max=0.3)
    assert k == jk == 4                              # 0.3+0.3+0.3+0.1
    np.testing.assert_allclose(w.particles.pos.numpy()[0], [2.0, -1.0],
                               rtol=1e-6)
    np.testing.assert_array_equal(w.particles.pos.numpy(),
                                  np.asarray(jw.particles.pos))


def test_matches_fixed_dt_when_clamped():
    scene = nt.make_galaxies(250, 1, seed=4)
    a = nt.create_world(scene, config=TINY, device="cpu")
    b = nt.create_world(scene, config=TINY, device="cpu")
    k = a.update_adaptive(0.1, dt_min=0.01, dt_max=0.01)
    b.update(0.01, 10)
    assert k in (10, 11)                            # fp t-accumulation
    np.testing.assert_allclose(a.particles.pos.numpy(),
                               b.particles.pos.numpy(), rtol=1e-4, atol=1e-3)


def test_tight_encounter_shrinks_dt():
    p = _both([[0.0, 0.0], [2.0, 0.0]], mass=[50.0, 50.0], radius=[0.5, 0.5])
    w, k, jw, jk = _adaptive_pair(p, 0.5, eta=0.05, dt_max=0.25)
    assert k > 10 and k == jk
    assert torch.isfinite(w.particles.pos).all()
    assert _scaled(w.particles.pos, jw.particles.pos) < 1e-5


@pytest.mark.parametrize("backend,jax_backend,integrator", [
    (b, jb, i) for b, jb in (("torch", "jnp"), ("torch", "pallas"), ("pm", "pm"))
    for i in ("euler", "leapfrog", "yoshida4")] + [("p3m", "p3m", "euler")])
def test_counts_and_state_match_nbody_tpu(backend, jax_backend, integrator):
    """The same galaxy scene through both packages' update_adaptive: equal
    substep counts, positions within tests/test_extra_force.py's bounds."""
    p = (nt.make_galaxies(256, 1, seed=13), nb.make_galaxies(256, 1, seed=13))
    cfg = dict(tile_targets=8, tile_sources=128, pm_grid=64,
               integrator=integrator)
    w, k, jw, jk = _adaptive_pair(p, 0.05, backend=backend,
                                  jax_backend=jax_backend, config=cfg,
                                  dt_max=0.02)
    assert k == jk, (k, jk)
    tol = 3e-3 if backend == "p3m" else 2e-5
    assert _scaled(w.particles.pos, jw.particles.pos) < tol


def test_adaptive_hook_matches_nbody_tpu():
    p = (nt.make_galaxies(256, 1, seed=17), nb.make_galaxies(256, 1, seed=17))
    hook = lambda pos, vel: -0.1 * vel  # noqa: E731
    w, k, jw, jk = _adaptive_pair(p, 0.02, dt_max=0.01, extra_force=hook)
    assert k == jk >= 2
    assert _scaled(w.particles.vel, jw.particles.vel) < 2e-5


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_batch_size_changes_nothing(batch, monkeypatch):
    """Substeps past the end keep the state: any batch gives the bits of
    the default one, the stored acc included, through the functional
    form."""
    scene = nt.make_galaxies(300, 2, seed=21)
    ref = nt.create_world(scene, device="cpu")
    k_ref = ref.update_adaptive(0.03, dt_max=0.01)
    w = nt.create_world(scene, device="cpu")
    monkeypatch.setattr(nt.world, "ADAPTIVE_BATCH", batch)
    st, k = nt.world.update_state_adaptive(
        w.state, w.gm, 0.03, dt_max=0.01, config=w.config, backend="torch")
    assert k == k_ref
    for name in ("pos", "vel", "acc"):
        assert torch.equal(getattr(st, name), getattr(ref.state, name)), name


def test_zero_span_takes_only_the_priming_substep():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=1), device="cpu")
    before = w.particles
    assert w.update_adaptive(0.0) == 0
    assert torch.equal(w.particles.pos, before.pos)
    assert torch.equal(w.particles.vel, before.vel)
    assert not torch.equal(w.particles.acc, before.acc)   # primed


@pytest.mark.parametrize("force_backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_adaptive_matches_single_device(force_backend):
    """The min over the shards reproduces the single-device dt sequence:
    the same count as the port's World and as nbody_tpu's."""
    scene = nt.make_galaxies(256, 1, seed=13)
    w = nt.create_world(scene, config=TINY, device="cpu")
    n_single = w.update_adaptive(0.05, dt_max=0.02)
    jw = nb.create_world(nb.make_galaxies(256, 1, seed=13), config=TINY_JAX)
    n_jax = jw.update_adaptive(0.05, dt_max=0.02, backend="jnp")
    sw = ShardedWorld(scene, _cpu_mesh(4), config=TINY,
                      force_backend=force_backend)
    n_sharded = sw.update_adaptive(0.05, dt_max=0.02)
    assert n_single == n_sharded == n_jax
    assert _scaled(sw.particles.pos, w.particles.pos) < 1e-4


def test_sharded_adaptive_matches_nbody_tpu_sharded():
    scene = nt.make_galaxies(256, 1, seed=13)
    sw = ShardedWorld(scene, _cpu_mesh(4), config=TINY, force_backend="torch")
    jw = jsh.ShardedWorld(nb.make_galaxies(256, 1, seed=13), jsh.make_mesh(4),
                          config=TINY_JAX, force_backend="jnp")
    hook = lambda pos, vel: -0.1 * vel  # noqa: E731
    assert (sw.update_adaptive(0.05, dt_max=0.02, extra_force=hook)
            == jw.update_adaptive(0.05, dt_max=0.02, extra_force=hook))
    assert _scaled(sw.particles.pos, jw.particles.pos) < 1e-4


def test_sharded_adaptive_force_free_counts_exactly():
    rng = np.random.default_rng(3)
    p = nt.make_particles(rng.normal(size=(64, 2)).astype(np.float32),
                          vel=rng.normal(size=(64, 2)).astype(np.float32))
    sw = ShardedWorld(p, _cpu_mesh(8), config=TINY, force_backend="torch")
    assert sw.update_adaptive(0.1, dt_max=0.01) in (10, 11)  # fp t-accum
    drift = sw.particles.pos.numpy() - p.pos.numpy()
    np.testing.assert_allclose(drift, 0.1 * p.vel.numpy(), atol=1e-6)


def test_sharded_adaptive_padding_rows_stay_zero():
    """Padding rows hold acc exactly 0 (timescale +inf) through the loop
    and never move."""
    sw = ShardedWorld(nt.make_galaxies(200, 1, seed=2), _cpu_mesh(4),
                      config=TINY, force_backend="cuda_ring")
    assert sw.n_pad > sw.total_len
    sw.update_adaptive(0.02, dt_max=0.01, extra_force=lambda p, v: 0 * p - 1)
    for name in ("pos", "vel", "acc"):
        pad = torch.cat(getattr(sw, name))[sw.total_len:]
        assert torch.equal(pad, torch.zeros_like(pad)), name
