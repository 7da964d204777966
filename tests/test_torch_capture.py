"""Trajectory capture, observable streaming, rendering, npz checkpoints and
debug checks in the port, on the CPU: the cases of
tests/test_trajectory.py, tests/test_render.py, the npz cases of
tests/test_checkpoint.py and tests/test_checks.py, each held against
nbody_tpu on the same numpy inputs.

Bounds: trajectories are held to nbody_tpu's by tests/test_torch_world.py's
bound on World.update (pos 1e-6 of max|pos|) and to the port's own
``update`` bit for bit; frames are equal byte for byte; checkpoints load in
both packages."""

import dataclasses
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu import render as jrender
from nbody_tpu import trajectory as jtraj
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu.utils import checkpoint as jck
from nbody_tpu_torch import render, trajectory
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.utils import checkpoint as ck
from nbody_tpu_torch.utils.checks import (CheckedWorld, SimulationDiverged,
                                          check_state,
                                          validate_world_invariants)

TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128)
POS_TOL = 1e-6   # tests/test_torch_world.py WORLD_TOL["pos"]


def _pair(n, galaxies, seed, config=TINY, jconfig=TINY_JAX):
    return (nt.create_world(nt.make_galaxies(n, galaxies, seed=seed),
                            config=config, device="cpu"),
            nb.create_world(nb.make_galaxies(n, galaxies, seed=seed),
                            config=jconfig))


# --- trajectory (tests/test_trajectory.py) --------------------------------

@pytest.mark.parametrize("integrator", ["euler", "yoshida4"])
def test_record_matches_stepping_and_nbody_tpu(integrator):
    cfg = dataclasses.replace(TINY, integrator=integrator)
    jcfg = dataclasses.replace(TINY_JAX, integrator=integrator)
    w1, j = _pair(250, 1, 4, cfg, jcfg)
    w2 = nt.create_world(nt.make_galaxies(250, 1, seed=4), config=cfg,
                         device="cpu")
    traj = trajectory.record_trajectory(w1, 0.01, frames=4, steps_per_frame=3,
                                        backend="torch")
    jt = jtraj.record_trajectory(j, 0.01, frames=4, steps_per_frame=3,
                                 backend="jnp")
    assert isinstance(traj, np.ndarray) and traj.shape == (4, 250, 2)
    for k in range(4):
        w2.update(0.01, 3, backend="torch")
        np.testing.assert_array_equal(traj[k], w2.particles.pos.numpy())
        assert rel_err(traj[k], jt[k]) < POS_TOL
    np.testing.assert_array_equal(w1.particles.pos.numpy(), traj[-1])


def test_trajectory_roundtrip_across_packages(tmp_path):
    w = nt.create_world(nt.make_galaxies(200, 1, seed=5), config=TINY,
                        device="cpu")
    traj = trajectory.record_trajectory(w, 0.01, frames=3, steps_per_frame=2)
    path = str(tmp_path / "traj.npz")
    trajectory.save_trajectory(path, traj, dt=np.float32(0.01))
    for load in (trajectory.load_trajectory, jtraj.load_trajectory):
        loaded, extra = load(path)
        np.testing.assert_array_equal(loaded, traj)
        assert float(extra["dt"]) == np.float32(0.01)


def test_p3m_capture_rebins_on_the_global_substep_index():
    """Capture carries the bins across frames: with rebin 4, 6 frames of 3
    substeps rebuild at global substeps 4, 8, 12, 16, as one update of 18
    does (an update per frame would rebuild at every frame's start)."""
    kw = dict(tile_targets=64, pm_grid=128, p3m_cell_capacity=32,
              p3m_rebin_interval=4)
    cfg, jcfg = nt.SimConfig(**kw), nb.SimConfig(**kw)
    w1, j = _pair(600, 1, 7, cfg, jcfg)
    w2 = nt.create_world(nt.make_galaxies(600, 1, seed=7), config=cfg,
                         device="cpu")
    traj = trajectory.record_trajectory(w1, 0.01, frames=6, steps_per_frame=3,
                                        backend="p3m")
    jt = jtraj.record_trajectory(j, 0.01, frames=6, steps_per_frame=3,
                                 backend="p3m")
    w2.update(0.01, 18, backend="p3m")
    np.testing.assert_array_equal(traj[-1], w2.particles.pos.numpy())
    np.testing.assert_array_equal(w1.particles.pos.numpy(), traj[-1])
    w3 = nt.create_world(nt.make_galaxies(600, 1, seed=7), config=cfg,
                         device="cpu")
    w3.update(0.01, 9, backend="p3m")
    np.testing.assert_array_equal(traj[2], w3.particles.pos.numpy())
    for k in range(6):
        assert rel_err(traj[k], jt[k]) < POS_TOL, k
    # frame by frame updates rebin at every frame's start: not the same
    w4 = nt.create_world(nt.make_galaxies(600, 1, seed=7), config=cfg,
                         device="cpu")
    for _ in range(6):
        w4.update(0.01, 3, backend="p3m")
    assert not np.array_equal(w4.particles.pos.numpy(), traj[-1])


def test_record_states_returns_gm_and_a_custom_capture():
    w = nt.create_world(nt.make_galaxies(250, 1, seed=4), config=TINY,
                        device="cpu")
    st, gm, cap = trajectory.record_states(
        w.state, w.gm, 0.01, frames=3, steps_per_frame=2, config=w.config,
        backend="torch", capture=lambda s, g: {"x": s.pos[:, 0].sum(),
                                               "g": g.sum()})
    assert cap["x"].shape == (3,) and torch.equal(gm, w.gm)
    assert torch.equal(cap["g"], torch.full((3,), float(w.gm.sum())))
    with pytest.raises(ValueError, match="frames"):
        trajectory.record_states(w.state, w.gm, 0.01, frames=0,
                                 steps_per_frame=1, config=w.config,
                                 backend="torch")


def test_record_observables_matches_nbody_tpu():
    w, j = _pair(300, 2, 6)
    got = trajectory.record_observables(w, 0.01, frames=3, steps_per_frame=2,
                                        backend="torch")
    want = jtraj.record_observables(j, 0.01, frames=3, steps_per_frame=2,
                                    backend="jnp")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["time"], want["time"])
    for key in ("kinetic", "potential", "momentum", "angular_momentum",
                "center_of_mass"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5,
                                   atol=1e-6 * np.abs(want[key]).max(),
                                   err_msg=key)
    with pytest.raises(ValueError, match="custom capture"):
        trajectory.record_observables(w, 0.01, 1, capture=lambda s, g: s.pos,
                                      energy="pm")


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_capture_matches_the_world_and_nbody_tpu(backend):
    scene = nt.make_galaxies(250, 1, seed=4)
    sw = ShardedWorld(scene, make_mesh(devices=["cpu"] * 4), config=TINY,
                      force_backend=backend)
    w = nt.create_world(scene, config=TINY, device="cpu")
    jw = jsh.ShardedWorld(nb.make_galaxies(250, 1, seed=4), jsh.make_mesh(4),
                          config=TINY_JAX, force_backend="jnp")
    traj = trajectory.record_trajectory_sharded(sw, 0.01, frames=3,
                                                steps_per_frame=2)
    jt = jw.record(0.01, frames=3, steps_per_frame=2)
    assert isinstance(traj, np.ndarray) and traj.shape == (3, 250, 2)
    for k in range(3):
        w.update(0.01, 2, backend="torch")
        assert rel_err(traj[k], w.particles.pos) < POS_TOL
        assert rel_err(traj[k], jt[k]) < POS_TOL
    s = nt.diagnostics.summary(sw)
    assert s["n"] == 250 and np.isfinite(s["kinetic_energy"])


def test_sharded_record_observables_matches_the_world():
    scene = nt.make_galaxies(250, 1, seed=4)
    sw = ShardedWorld(scene, make_mesh(devices=["cpu"] * 2), config=TINY)
    w = nt.create_world(scene, config=TINY, device="cpu")
    got = sw.record_observables(0.01, frames=2, steps_per_frame=2)
    want = trajectory.record_observables(w, 0.01, frames=2, steps_per_frame=2)
    assert set(got) == set(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(v).max(), 1e-30),
                                   err_msg=key)


# --- render (tests/test_render.py) ----------------------------------------

def test_fit_camera_matches_nbody_tpu():
    rng = np.random.default_rng(0)
    for pos in (np.array([[0.0, 0.0], [10.0, 20.0]], np.float32),
                (1e4 * rng.normal(size=(500, 2))).astype(np.float32),
                np.zeros((0, 2), np.float32)):
        for w, h in ((1280, 720), (160, 120)):
            assert render.fit_camera(torch.from_numpy(pos), w, h) == \
                render.Camera(**dataclasses.asdict(jrender.fit_camera(pos, w, h)))
    cam = render.fit_camera(np.array([[0.0, 0.0], [10.0, 20.0]], np.float32))
    assert (cam.center_x, cam.center_y, cam.zoom) == (5.0, 10.0, 1.0)


def test_classify_mass():
    m = torch.tensor([0.0, 1.0, 1e12, -1.0])
    assert render.classify_mass(m).tolist() == [1, 2, 3, 1]
    np.testing.assert_array_equal(
        render.classify_mass(m).numpy(),
        np.asarray(jrender.classify_mass(jnp.asarray(m.numpy()))))


def _frames(particles, camera=None, **kw):
    got = render.render_frame(particles, camera, **dict(kw))
    jp = nb.make_particles(particles.pos.numpy(), vel=particles.vel.numpy(),
                           mass=particles.mass.numpy(),
                           radius=particles.radius.numpy())
    jcam = None if camera is None else jrender.Camera(
        **dataclasses.asdict(camera))
    want = jrender.render_frame(jp, jcam, **dict(kw))
    return got, want


@pytest.mark.parametrize("kind", ["galaxies", "zoomed", "offscreen", "odd"])
def test_frames_are_byte_equal_to_nbody_tpu(kind):
    p = nt.make_galaxies(2000, 2, seed=3)
    cam = None
    kw = {"width": 320, "height": 200}
    if kind == "zoomed":                      # disks past the stamp
        cam = render.Camera(float(p.pos[0, 0]), float(p.pos[0, 1]), 3.7,
                            320, 200)
        kw = {}
    elif kind == "offscreen":                 # half the particles off the frame
        cam = render.Camera(float(p.pos[:, 0].max()), 0.0, 0.02, 160, 90)
        kw = {}
    elif kind == "odd":                       # half-pixel positions, NaN, inf
        pos = p.pos.clone()
        pos[:20] = torch.tensor([0.5, 1.5])
        pos[20] = float("nan")
        pos[21] = float("inf")
        pos[22] = torch.tensor([3e9, -3e9])
        p = nt.make_particles(pos, vel=p.vel, mass=p.mass, radius=p.radius)
        cam = render.Camera(0.0, 0.0, 1.0, 64, 48)
        kw = {}
    got, want = _frames(p, cam, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_render_smoke_colors_present():
    p = nt.make_particles(
        np.array([[0.0, 0.0], [5.0, 0.0], [-5.0, 0.0]], np.float32),
        mass=np.array([2e10, 1.0, 0.0], np.float32),
        radius=np.array([3.0, 1.0, 0.5], np.float32))
    img = render.render_frame(p, render.Camera(0.0, 0.0, 4.0, 120, 80))
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    for c in (render.BG_COLOR, render.CC_COLOR, render.NP_COLOR,
              render.EP_COLOR):
        assert c in colors


def test_core_priority_over_tracer():
    p = nt.make_particles(np.zeros((2, 2), np.float32),
                          mass=np.array([0.0, 2e10], np.float32),
                          radius=np.array([0.5, 3.0], np.float32))
    img = render.render_frame(p, render.Camera(0.0, 0.0, 1.0, 20, 20))
    assert tuple(img[10, 10]) == render.CC_COLOR


def test_save_ppm(tmp_path):
    img = np.zeros((3, 4, 3), np.uint8)
    img[1, 2] = (1, 2, 3)
    path = str(tmp_path / "f.ppm")
    render.save_ppm(path, img)
    jpath = str(tmp_path / "j.ppm")
    jrender.save_ppm(jpath, img)
    raw = open(path, "rb").read()
    assert raw.startswith(b"P6\n4 3\n255\n") and raw == open(jpath, "rb").read()


def test_export_animation_npz(tmp_path):
    from nbody_tpu_torch.viewer import export_animation

    w = nt.create_world(nt.make_galaxies(300, 1, seed=2), device="cpu")
    ref = nt.create_world(nt.make_galaxies(300, 1, seed=2), device="cpu")
    path = str(tmp_path / "a.npz")
    export_animation(w, path, frames=2, steps_per_frame=1, width=64, height=48)
    with np.load(path) as d:
        frames = d["frames"]
    assert frames.shape == (2, 48, 64, 3) and frames.dtype == np.uint8
    cam = render.fit_camera(ref.particles.pos, 64, 48)
    ref.update(0.01, 1)
    ref.update(0.01, 1)
    np.testing.assert_array_equal(frames[1], render.render_frame(
        ref.particles, cam))


# --- npz checkpoints (tests/test_checkpoint.py) ---------------------------

def test_particles_roundtrip(tmp_path):
    scene = nt.make_galaxies(300, 2, seed=1)
    path = str(tmp_path / "state.npz")
    ck.save_particles(path, scene, step=np.int64(7))
    loaded, extra = ck.load_particles(path)
    assert torch.equal(loaded.pos, scene.pos)
    assert torch.equal(loaded.mass, scene.mass)
    assert int(extra["step"]) == 7


def test_world_resume_continues_identically(tmp_path):
    w = nt.create_world(nt.make_galaxies(250, 1, seed=2), config=TINY,
                        device="cpu")
    w.update(0.01, 3, backend="torch")
    path = str(tmp_path / "ckpt.npz")
    ck.save_world(path, w, step=3)
    resumed, step = ck.load_world(path, device="cpu")
    assert step == 3 and resumed.mass_len == w.mass_len
    assert resumed.config == TINY
    w.update(0.01, 4, backend="torch")
    resumed.update(0.01, 4, backend="torch")
    assert torch.equal(resumed.particles.pos, w.particles.pos)


def test_checkpoints_load_across_the_two_packages(tmp_path):
    """The same file format: a port checkpoint resumes in nbody_tpu and an
    nbody_tpu checkpoint in the port, config and all; each package drops
    the fields its SimConfig lacks."""
    cfg = dataclasses.replace(TINY, integrator="leapfrog", pm_softening=3.5,
                              merge_collisions=True, merge_factor=1.25)
    w = nt.create_world(nt.make_galaxies(250, 1, seed=2), config=cfg,
                        device="cpu")
    w.update(0.01, 2)
    path = str(tmp_path / "port.npz")
    ck.save_world_atomic(path, w, step=2)
    jw, step = jck.load_world(path)
    assert step == 2
    for f in dataclasses.fields(cfg):
        assert getattr(jw.config, f.name) == getattr(cfg, f.name), f.name
    np.testing.assert_array_equal(np.asarray(jw.particles.pos),
                                  w.particles.pos.numpy())

    jcfg = dataclasses.replace(TINY_JAX, integrator="yoshida4",
                               kernel_tile_targets=256, merge_collisions=True)
    j = nb.create_world(nb.make_galaxies(250, 1, seed=3), config=jcfg)
    j.update(0.01, 2, backend="jnp")
    jpath = str(tmp_path / "jax.npz")
    jck.save_world(jpath, j, step=5)
    pw, step = ck.load_world(jpath, device="cpu")
    assert step == 5 and pw.config.integrator == "yoshida4"
    assert pw.config.merge_collisions and not hasattr(pw.config,
                                                      "kernel_tile_targets")
    np.testing.assert_array_equal(pw.particles.pos.numpy(),
                                  np.asarray(j.particles.pos))
    assert pw.mass_len == j.mass_len


def test_save_world_atomic_overwrites_cleanly_and_honors_umask(tmp_path):
    w = nt.create_world(nt.make_galaxies(120, 1, seed=8), device="cpu")
    path = str(tmp_path / "ck.npz")
    old = os.umask(0o022)
    try:
        ck.save_world_atomic(path, w, step=1)
        w.update(0.01, 2, backend="torch")
        ck.save_world_atomic(path, w, step=3)
    finally:
        os.umask(old)
    w2, step = ck.load_world(path, device="cpu")
    assert step == 3
    assert torch.equal(w2.particles.pos, w.particles.pos)
    assert [f for f in os.listdir(tmp_path) if f.startswith(".ckpt-")] == []
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o644


def test_unreadable_saved_config_warns_and_defaults(tmp_path):
    p = nt.make_galaxies(120, 1, seed=8)
    path = str(tmp_path / "bad.npz")
    ck.save_particles(path, p, sim_config="{not json")
    with pytest.warns(UserWarning, match="sim_config"):
        w, _ = ck.load_world(path, device="cpu")
    assert w.config == nt.SimConfig()


def test_sharded_world_checkpoints(tmp_path):
    scene = nt.make_galaxies(300, 1, seed=8)
    sw = ShardedWorld(scene, make_mesh(devices=["cpu"] * 4), config=TINY)
    sw.update(0.01, 2)
    path = str(tmp_path / "s.npz")
    ck.save_world(path, sw, step=2)
    w, step = ck.load_world(path, device="cpu")
    assert step == 2 and torch.equal(w.particles.pos, sw.particles.pos)


# --- checks (tests/test_checks.py) -----------------------------------------

def test_healthy_state_passes():
    w = nt.create_world(nt.make_galaxies(200, 1, seed=1), config=TINY,
                        device="cpu")
    w.update(0.01, 3, backend="torch")
    check_state(w.state)
    validate_world_invariants(w)


def test_nan_detected():
    w = nt.create_world(nt.make_particles(np.array([[np.nan, 0.0]],
                                                   np.float32)), device="cpu")
    with pytest.raises(SimulationDiverged, match="pos"):
        check_state(w.state)


def test_checked_world_catches_divergence():
    p = nt.make_particles(np.zeros((2, 2), np.float32),
                          mass=np.array([10.0, 10.0], np.float32),
                          radius=np.array([1.0, 1.0], np.float32))
    cw = CheckedWorld(nt.create_world(p, config=TINY, device="cpu"))
    with pytest.raises(SimulationDiverged):
        cw.update(0.01, 1, backend="torch",
                  extra_force=lambda pos, vel: 0.0 * pos + float("nan"))


def test_checked_world_passthrough_and_adaptive():
    cw = CheckedWorld(nt.create_world(nt.make_galaxies(200, 1, seed=2),
                                      config=TINY, device="cpu"))
    cw.update(0.01, 2, backend="torch")
    assert cw.total_len == 200 and torch.isfinite(cw.particles.pos).all()
    assert cw.update_adaptive(0.05, dt_max=0.01) >= 5
    with pytest.raises(SimulationDiverged):
        cw.update_adaptive(0.02, dt_max=0.01,
                           extra_force=lambda pos, vel: 0.0 * pos + float("nan"))


def test_validator_and_checked_world_accept_sharded_worlds():
    scene = nt.make_galaxies(300, 1, seed=8)
    sw = ShardedWorld(scene, make_mesh(devices=["cpu"] * 4), config=TINY)
    sw.update(0.01, 4)
    validate_world_invariants(sw)
    merged = CheckedWorld(ShardedWorld(
        scene, make_mesh(devices=["cpu"] * 4),
        config=dataclasses.replace(TINY, merge_collisions=True)))
    merged.update(0.01, 8)
    validate_world_invariants(merged)
    assert merged.state.pos.shape == (merged.n_pad, 2)
