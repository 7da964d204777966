"""The port's command line, ``python -m nbody_tpu_torch run|render|gif``, on
the CPU (``--platform cpu``): the run, render and gif cases of
tests/test_app.py and tests/test_collisions.py::test_cli_merge_flag, each
held against nbody_tpu's CLI on the same scene where both produce state.

Bounds: tests/test_collisions.py's (masses equal, positions within 1e-5 of
max|pos|); frames byte for byte."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nbody_tpu.app import main as jax_main
from nbody_tpu.utils.checkpoint import load_world as jax_load_world
from nbody_tpu_torch.app import main as port_main
from nbody_tpu_torch.utils.checkpoint import load_world, save_particles

import nbody_tpu_torch as nt

POS_TOL = 1e-5
SCENE = ["--n", "250", "--galaxies", "1"]


def main(argv):
    port_main(["--platform", "cpu", *argv])


def _close(a, b):
    with np.load(a) as da, np.load(b) as db:
        np.testing.assert_array_equal(da["mass"], db["mass"])
        assert int(da["step"]) == int(db["step"])
        ref = np.abs(db["pos"]).max()
        assert np.abs(da["pos"] - db["pos"]).max() / ref < POS_TOL


def test_run_save_render_match_nbody_tpu(tmp_path):
    state, jstate = str(tmp_path / "s.npz"), str(tmp_path / "j.npz")
    out, jout = str(tmp_path / "f.ppm"), str(tmp_path / "j.ppm")
    main(["run", *SCENE, "--steps", "5", "--save", state])
    jax_main(["run", *SCENE, "--steps", "5", "--save", jstate])
    _close(state, jstate)
    main(["render", "--state", state, "--out", out, "--width", "160",
          "--height", "120"])
    raw = open(out, "rb").read()
    assert raw.startswith(b"P6\n160 120\n255\n")
    # the same state renders to the same bytes in both packages
    jax_main(["render", "--state", state, "--out", jout, "--width", "160",
              "--height", "120"])
    assert raw == open(jout, "rb").read()


def test_run_traj(tmp_path):
    traj, jtraj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    main(["run", *SCENE, "--steps", "8", "--frames", "4", "--traj", traj])
    jax_main(["run", *SCENE, "--steps", "8", "--frames", "4", "--traj", jtraj])
    with np.load(traj) as d, np.load(jtraj) as j:
        assert d["traj"].shape == (4, 250, 2)
        assert int(d["steps_per_frame"]) == 2 and float(d["dt"]) == float(j["dt"])
        assert np.abs(d["traj"] - j["traj"]).max() / np.abs(j["traj"]).max() \
            < POS_TOL


def test_resume_from_state_accumulates_steps(tmp_path):
    state, state2 = str(tmp_path / "s.npz"), str(tmp_path / "s2.npz")
    main(["run", *SCENE, "--steps", "2", "--save", state])
    main(["run", "--state", state, "--steps", "2", "--save", state2])
    with np.load(state2) as d:
        assert d["pos"].shape == (250, 2) and int(d["step"]) == 4


def test_checkpoint_every_parity_and_resume(tmp_path):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    main(["run", *SCENE, "--steps", "5", "--save", a, "--checkpoint-every", "2"])
    main(["run", *SCENE, "--steps", "5", "--save", b])
    with np.load(a) as da, np.load(b) as db:
        np.testing.assert_array_equal(da["pos"], db["pos"])
        assert int(da["step"]) == 5 == int(db["step"])
    main(["run", "--state", a, "--steps", "3", "--checkpoint-every", "2",
          "--save", a])
    with np.load(a) as d:
        assert int(d["step"]) == 8


def test_gif_export_npz_matches_nbody_tpu(tmp_path):
    out, jout = str(tmp_path / "a.npz"), str(tmp_path / "j.npz")
    args = [*SCENE, "--frames", "3", "--steps-per-frame", "1", "--width",
            "80", "--height", "60"]
    main(["gif", *args, "--out", out])
    jax_main(["gif", *args, "--out", jout])
    with np.load(out) as d, np.load(jout) as j:
        assert d["frames"].shape == (3, 60, 80, 3)
        assert d["frames"].dtype == np.uint8
        # the first frame's state is within the world bounds of nbody_tpu's;
        # the pixels of both packages agree where the positions do
        assert (d["frames"] == j["frames"]).mean() > 0.99


def test_gif_export_gif(tmp_path):
    pytest.importorskip("PIL")
    out = str(tmp_path / "anim.gif")
    main(["gif", *SCENE, "--frames", "3", "--steps-per-frame", "1", "--out",
          out, "--width", "80", "--height", "60"])
    assert open(out, "rb").read(6) in (b"GIF87a", b"GIF89a")


@pytest.mark.parametrize("argv", [["run", "--bogus"],
                                  ["run", "--backend", "jnp"],
                                  ["run", "--backend", "pallas"]])
def test_bad_args_exit(argv):
    with pytest.raises(SystemExit):
        main(argv)


def test_merge_p3m_combination_rejected_cleanly():
    with pytest.raises(SystemExit, match="not supported"):
        main(["run", "--n", "400", "--galaxies", "1", "--steps", "1",
              "--merge", "--backend", "p3m"])


def test_pm_grid_auto(tmp_path, capsys):
    state = str(tmp_path / "s.npz")
    main(["run", *SCENE, "--steps", "2", "--backend", "pm", "--pm-grid",
          "auto", "--save", state])
    assert "pm_grid auto -> 256" in capsys.readouterr().err
    assert load_world(state, device="cpu")[0].config.pm_grid == 256


def test_backend_auto_cli(tmp_path, capsys):
    state = str(tmp_path / "auto.npz")
    main(["run", *SCENE, "--steps", "3", "--backend", "auto", "--save", state])
    assert "backend=torch" in capsys.readouterr().err
    with np.load(state) as z:
        assert np.isfinite(z["pos"]).all()


def test_run_sharded_save_traj_and_matches_single_device(tmp_path, capsys):
    state, single = str(tmp_path / "s.npz"), str(tmp_path / "one.npz")
    main(["run", *SCENE, "--steps", "4", "--shard", "--save", state])
    assert "x1dev" in capsys.readouterr().err
    main(["run", *SCENE, "--steps", "4", "--save", single])
    with np.load(state) as d, np.load(single) as one:
        assert d["pos"].shape == (250, 2) and int(d["step"]) == 4
        assert np.abs(d["pos"] - one["pos"]).max() / np.abs(one["pos"]).max() \
            < POS_TOL
    traj = str(tmp_path / "t.npz")
    main(["run", *SCENE, "--steps", "6", "--frames", "3", "--shard", "--traj",
          traj])
    with np.load(traj) as d:
        assert d["traj"].shape == (3, 250, 2)
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["run", *SCENE, "--steps", "1", "--shard", "--backend", "pm"])


def test_checkpoint_every_negative_rejected(tmp_path):
    with pytest.raises(SystemExit):
        main(["run", *SCENE, "--steps", "5", "--save",
              str(tmp_path / "never.npz"), "--checkpoint-every", "-2"])


def test_traj_save_counts_only_executed_substeps(tmp_path):
    traj, state = str(tmp_path / "t.npz"), str(tmp_path / "s.npz")
    main(["run", *SCENE, "--steps", "7", "--frames", "3", "--traj", traj,
          "--save", state])
    with np.load(state) as d:
        assert int(d["step"]) == 6


def test_dt_auto(tmp_path, capsys):
    state = str(tmp_path / "dtauto.npz")
    main(["run", *SCENE, "--steps", "3", "--dt", "auto", "--save", state])
    err = capsys.readouterr().err
    dt = float(err.split("dt auto -> ")[1].split()[0])
    jax_main(["run", *SCENE, "--steps", "3", "--dt", "auto"])
    jdt = float(capsys.readouterr().err.split("dt auto -> ")[1].split()[0])
    assert 0.0 < dt < 10.0 and dt == pytest.approx(jdt, rel=1e-5)


@pytest.mark.parametrize("case,match", [("massless", "force-free"),
                                        ("zero_radius", "timescale")])
def test_dt_auto_rejects_worlds_without_a_timescale(tmp_path, case, match):
    sc = nt.make_galaxies(250, 1, seed=3)
    mass, radius = sc.mass.clone(), sc.radius.clone()
    if case == "massless":
        mass.zero_()
    else:
        radius[-1] = 0.0
    state = str(tmp_path / "x.npz")
    save_particles(state, nt.make_particles(sc.pos, vel=sc.vel, mass=mass,
                                            radius=radius))
    with pytest.raises(SystemExit, match=match):
        main(["run", "--state", state, "--steps", "1", "--dt", "auto"])


def test_resume_inherits_saved_config(tmp_path):
    state, s2 = str(tmp_path / "state.npz"), str(tmp_path / "s2.npz")
    main(["run", *SCENE, "--steps", "2", "--integrator", "leapfrog",
          "--pm-softening", "3.5", "--save", state])
    w, step = load_world(state, device="cpu")
    assert step == 2 and w.config.integrator == "leapfrog"
    assert w.config.pm_softening == 3.5
    main(["run", "--state", state, "--steps", "1", "--save", s2,
          "--pm-softening", "4.0"])
    w2, _ = load_world(s2, device="cpu")
    assert w2.config.integrator == "leapfrog" and w2.config.pm_softening == 4.0


def test_run_adaptive(tmp_path, capsys):
    out = str(tmp_path / "ad.npz")
    main(["run", "--n", "300", "--galaxies", "1", "--adaptive", "0.02",
          "--dt", "0.01", "--save", out])
    err = capsys.readouterr().err
    k = int(err.split(" adaptive substeps")[0].split()[-1])
    jout = str(tmp_path / "jad.npz")
    jax_main(["run", "--n", "300", "--galaxies", "1", "--adaptive", "0.02",
              "--dt", "0.01", "--save", jout])
    jerr = capsys.readouterr().err
    assert k == int(jerr.split(" adaptive substeps")[0].split()[-1])
    _close(out, jout)
    with pytest.raises(SystemExit, match="does not compose"):
        main(["run", "--n", "300", "--galaxies", "1", "--adaptive", "0.02",
              "--traj", str(tmp_path / "t.npz")])


def test_adaptive_bad_span_and_resumed_merge_p3m_rejected(tmp_path):
    with pytest.raises(SystemExit, match="must be > 0"):
        main(["run", "--n", "300", "--galaxies", "1", "--adaptive", "-1"])
    state = str(tmp_path / "m.npz")
    main(["run", "--n", "300", "--galaxies", "1", "--steps", "1", "--merge",
          "--save", state])
    with pytest.raises(SystemExit, match="not supported"):
        main(["run", "--state", state, "--steps", "1", "--backend", "p3m"])


def test_cli_merge_flag_and_resume_across_packages(tmp_path):
    """--merge runs the merging path, the checkpoint carries it, a resume
    without the flag keeps it, and nbody_tpu's CLI resumes the port's
    checkpoint (and the port nbody_tpu's) with the same physics."""
    state, jstate = str(tmp_path / "m.npz"), str(tmp_path / "jm.npz")
    main(["run", *SCENE, "--steps", "3", "--merge", "--save", state])
    jax_main(["run", *SCENE, "--steps", "3", "--merge", "--save", jstate])
    _close(state, jstate)
    w, _ = load_world(state, device="cpu")
    assert w.config.merge_collisions and w.config.merge_factor == 1.0
    s2, js2 = str(tmp_path / "m2.npz"), str(tmp_path / "jm2.npz")
    main(["run", "--state", jstate, "--steps", "1", "--save", s2])
    jax_main(["run", "--state", state, "--steps", "1", "--save", js2])
    assert load_world(s2, device="cpu")[0].config.merge_collisions
    assert jax_load_world(js2)[0].config.merge_collisions
    with np.load(s2) as a, np.load(js2) as b:
        assert json.loads(str(a["sim_config"]))["merge_collisions"] is True
        assert int(a["step"]) == int(b["step"]) == 4


def test_merging_run_matches_nbody_tpu(tmp_path):
    """A dense cluster that merges: the CLI's merging run against
    nbody_tpu's, masses equal."""
    rng = np.random.default_rng(1)
    n = 64
    p = nt.make_particles(rng.uniform(-3, 3, (n, 2)).astype(np.float32),
                          vel=rng.normal(0, 0.2, (n, 2)).astype(np.float32),
                          mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
                          radius=np.full(n, 0.4, np.float32))
    start = str(tmp_path / "c.npz")
    save_particles(start, p)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    main(["run", "--state", start, "--steps", "20", "--dt", "0.001",
          "--merge", "--save", a])
    jax_main(["run", "--state", start, "--steps", "20", "--dt", "0.001",
              "--merge", "--save", b])
    _close(a, b)
    with np.load(a) as d:
        assert int((d["mass"] > 0).sum()) < n


def test_other_scenes_exit_naming_the_roadmap():
    with pytest.raises(SystemExit, match="A10"):
        main(["run", "--n", "300", "--scene", "plummer", "--steps", "1"])


def test_the_cli_needs_a_card_unless_told_cpu(tmp_path):
    """Without --platform cpu the CLI runs on "cuda"; with no card it exits
    non-zero with a message and does not fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["run", *SCENE, "--steps", "1"])
    with pytest.raises(SystemExit, match="--platform"):
        port_main(["--platform", "tpu", "run", *SCENE, "--steps", "1"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "nbody_tpu_torch", "render",
                           "--state", "x.npz", "--out", "y.ppm"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
