"""Every module of nbody_tpu_torch.examples run end to end on the CPU with
the tiny arguments of tests/test_examples.py and its assertions, through
runpy as a user's ``python -m nbody_tpu_torch.examples.<name> ...
--device cpu`` runs it. checkpoint_resume, sharded and collision are held
against the JAX scripts of examples/ run with the same arguments: the
final particles at the packages' tolerance, the collision frames byte for
byte. Without a card, each refuses its default device, "cuda".

Two galaxies in fp32 are chaotic: two summation orders of the same run
drift apart by ~1e-4 of max|pos| within ~150 substeps, in nbody_tpu alone
("jnp" against "pallas", its World against its sharded world) as between
the packages. So checkpoint_resume is held at the packages' tolerance
with steps=2 (22 substeps), and sharded, whose script runs 120 substeps
whatever its arguments, at the larger of that tolerance and the spread
of nbody_tpu's own two orders over the same run."""

import os
import runpy
import sys

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
NAMES = ("checkpoint_resume", "sharded", "collision", "pm_million",
         "accretion", "shooting", "thrust_control", "multihost_pod")
# tests/test_torch_world.py:142, between the packages
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}


def _port(name, argv, monkeypatch, device="cpu"):
    argv = [str(a) for a in argv] + (["--device", device] if device else [])
    monkeypatch.setattr(sys, "argv", [name] + argv)
    return runpy.run_module(f"nbody_tpu_torch.examples.{name}",
                            run_name="__main__")


def _jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    return runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"),
                          run_name="__main__")


def _is_gif(path):
    return open(path, "rb").read(6) in (b"GIF87a", b"GIF89a")


@pytest.fixture(scope="module")
def mp():
    with pytest.MonkeyPatch.context() as m:
        yield m


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mp):
    """The three examples held against nbody_tpu, each run once in each
    package with the same arguments."""
    d = tmp_path_factory.mktemp("examples")
    out = {}
    for pkg, run in (("port", _port), ("jax", _jax)):
        ck = [400, 2, d / f"{pkg}_ck.npz", d / f"{pkg}_tr.npz"]
        col = [d / f"{pkg}_c.npz", 400, 2]
        out[pkg] = {
            "checkpoint_resume": run("checkpoint_resume", ck, mp),
            "sharded": run("sharded", [1024, "--cpu-demo"], mp),
            "collision": run("collision", col, mp),
            "frames": np.load(col[0])["frames"],
        }
    return out


def _held(got, want, tol=WORLD_TOL):
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    for name, bound in tol.items():
        err = rel_err(getattr(got, name), getattr(want, name))
        assert err < bound, (name, err, bound)


def test_checkpoint_resume(tmp_path, monkeypatch):
    g = _port("checkpoint_resume",
              [400, 20, tmp_path / "ck.npz", tmp_path / "tr.npz"], monkeypatch)
    assert g["traj"].shape == (20, 400, 2)
    assert np.isfinite(np.asarray(g["traj"])).all()
    assert g["step"] == 20


def test_checkpoint_resume_matches_nbody_tpu(runs):
    got = runs["port"]["checkpoint_resume"]
    want = runs["jax"]["checkpoint_resume"]
    assert got["traj"].shape == np.asarray(want["traj"]).shape == (2, 400, 2)
    _held(got["resumed"].particles, want["resumed"].particles)
    assert rel_err(got["traj"], want["traj"]) < WORLD_TOL["pos"]


def test_sharded(runs):
    g = runs["port"]["sharded"]
    sw, sw2 = g["sw"], g["sw2"]
    assert sw.n_devices == 8 and g["step"] == 120
    assert np.isfinite(sw.particles.pos.numpy()).all()
    # the demo's shard-native round trip restored every shard bit for bit
    for f in ("pos", "vel", "acc", "mass", "radius"):
        for a, b in zip(getattr(sw2, f), getattr(sw, f)):
            assert torch.equal(a, b), f


def test_sharded_matches_nbody_tpu(runs):
    """The script's 120 substeps (100, then 5 frames of 4) against
    nbody_tpu's, at the larger of the packages' tolerance and the spread
    between nbody_tpu's sharded world and its World ("jnp") over the same
    substeps from the same scene."""
    import nbody_tpu as nb

    got, want = runs["port"]["sharded"]["sw"], runs["jax"]["sharded"]["sw"]
    assert (got.n_devices, got.t_loc, got.s_loc) == \
        (want.n_devices, want.t_loc, want.s_loc)
    one = nb.create_world(nb.make_galaxies(1024, 2, seed=11037))
    one.update(0.01, 120, backend="jnp")
    spread = {name: rel_err(getattr(one.particles, name),
                            getattr(want.particles, name))
              for name in WORLD_TOL}
    _held(got.particles, want.particles,
          {name: max(tol, spread[name]) for name, tol in WORLD_TOL.items()})


def test_collision(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    out = str(tmp_path / "c.gif")
    _port("collision", [out, 400, 2], monkeypatch)
    assert _is_gif(out)


def test_collision_frames_match_nbody_tpu(runs):
    got, want = runs["port"]["frames"], runs["jax"]["frames"]
    assert got.shape == (2, 360, 640, 3) and got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()


def test_pm_million(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    out = str(tmp_path / "pm.gif")
    g = _port("pm_million", [4096, 2, "pm", out], monkeypatch)
    assert _is_gif(out)
    assert np.isfinite(g["world"].particles.pos.numpy()).all()


def test_shooting(monkeypatch):
    g = _port("shooting", [40], monkeypatch)
    # descent ran: finite loss, and the launch velocity moved off its seed
    assert np.isfinite(float(g["l"]))
    assert not np.allclose(g["v0"].numpy(), [10.0, 0.0])


def test_thrust_control(monkeypatch):
    g = _port("thrust_control", [30], monkeypatch)
    # descent ran: objective finite and the schedule moved off zero
    assert np.isfinite(float(g["l"]))
    assert not np.allclose(g["schedule"].numpy(), 0.0)


def test_accretion(monkeypatch):
    g = _port("accretion", [64, 300], monkeypatch)
    p = g["world"].particles
    assert int((p.mass > 0).sum()) < 64   # mergers happened
    assert np.isfinite(p.pos.numpy()).all()


def test_multihost_pod(monkeypatch):
    # single-process mode (the 2-process path runs in
    # tests/test_torch_multihost.py); gather_particles equals particles
    g = _port("multihost_pod", [1024, "--cpu-demo"], monkeypatch)
    parts = g["parts"]
    assert parts.pos.shape == (1024, 2)
    assert np.isfinite(parts.pos.numpy()).all()
    for f in ("pos", "vel", "acc", "mass", "radius"):
        assert torch.equal(getattr(parts, f), getattr(g["world"].particles, f))


@pytest.mark.parametrize("name", NAMES)
def test_refuses_cuda_without_a_card(name, monkeypatch):
    """An example runs on the card by default: without one it raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name, [], monkeypatch, device=None)
