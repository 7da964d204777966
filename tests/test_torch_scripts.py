"""nbody_tpu_torch.scripts.scale_ceiling and verify_drive on the CPU.

scale_ceiling at N=4096, grid 64, 2 substeps: its device scene, fed to
nbody_tpu's create_world with default_backend="pm" and run the same
substeps, is held at tests/test_torch_pm.py's tolerances (pos 1e-6, acc
1e-5 of max|x|). scripts/scale_ceiling.py is not run here: at import it
sets JAX's process-global compilation-cache directory. verify_drive runs
its drive at N=600 over 100 substeps with its probes unchanged; the
torch/cuda mix probe runs "cuda" on CPU tensors (the plain versions)
through a stubbed backend check. Without a card each script refuses its
default device."""

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

from nbody_tpu_torch import world as world_mod
from nbody_tpu_torch.scripts import scale_ceiling, validate_physics, verify_drive


def test_scale_ceiling_on_the_cpu_matches_nbody_tpus_pm(capsys):
    import nbody_tpu as nb

    got = scale_ceiling.main(["4096", "64", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("scene on device: N=4096 in ")
    assert out[1].startswith("world created in ") and out[1].endswith(
        f"(massive={got['mass_len']})")
    assert out[2].startswith("pm N=4096 grid=64: ")
    assert out[-2:] == ["memory: not measured on the CPU", "OK"]
    assert got["ms"] > 0 and got["world_s"] >= 0 and got["substeps"] == 2
    scene = got["scene"]
    assert scene.pos.shape == (4096, 2) and scene.pos.device.type == "cpu"

    jw = nb.create_world(nb.make_particles(
        scene.pos.numpy(), vel=scene.vel.numpy(), mass=scene.mass.numpy(),
        radius=scene.radius.numpy()), config=nb.SimConfig(pm_grid=64),
        default_backend="pm")
    jw.update(scale_ceiling.DT, 1)
    jw.update(scale_ceiling.DT, 2)
    want, p = jw.particles, got["world"].particles
    assert jw.mass_len == got["mass_len"]
    np.testing.assert_array_equal(p.mass.numpy(), np.asarray(want.mass))
    assert rel_err(p.pos, want.pos) < 1e-6
    assert rel_err(p.acc, want.acc) < 1e-5


def test_verify_drive_on_the_cpu(tmp_path, monkeypatch, capsys):
    def check(backend, device):
        if backend not in world_mod.BACKENDS:
            raise ValueError(backend)

    monkeypatch.setattr(world_mod, "_check_backend", check)
    monkeypatch.setattr(verify_drive, "direct_backend", lambda device: "cuda")
    out = tmp_path / "frame.ppm"
    got = verify_drive.main(["600", "100", "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("drive: N=600 x 100 steps OK; frame lit px=")
    assert lines[-1] == "verify_drive: ALL OK"
    assert got["mix"] == ("torch", "cuda") and got["mix_err"] < 1e-5
    assert got["lit"] > 100
    assert out.read_bytes().startswith(b"P6\n640 360\n255\n")


def test_verify_drive_writes_under_build_by_default(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = verify_drive.main(["300", "2", "--device", "cpu"])
    assert got["frame"] == "build/verify_frame.ppm"
    assert (tmp_path / "build" / "verify_frame.ppm").is_file()
    assert got["mix"] == ("torch", "torch") and got["mix_err"] == 0.0


@pytest.mark.parametrize("script", [validate_physics, scale_ceiling,
                                    verify_drive])
def test_each_script_refuses_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["4096"])
