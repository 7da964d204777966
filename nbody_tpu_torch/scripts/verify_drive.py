"""End-to-end drive of the library on the card: scene -> world -> update ->
render, and the behaviour probes.

Counterpart of ``scripts/verify_drive.py``: N=6000 in 3 galaxies over
2000 substeps with a rendered, lit frame (written to
``build/verify_frame.ppm``); then ``make_galaxies(150, 2)``'s
``ValueError``, a massless pure drift that a negative dt reverses, a
single particle's zero self-force, and the direct kernel ("cuda") and
"torch" alternated mid-run within 1e-5 of "torch" alone. On the CPU the
device's direct backend is "torch", so the last probe alternates "torch"
with itself.

Usage: python -m nbody_tpu_torch.scripts.verify_drive [N] [steps]
       [--out frame.ppm] [--device cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.render import fit_camera, render_frame, save_ppm

SEED = 11037
MIX_BOUND = 1e-5


def direct_backend(device: torch.device) -> str:
    """The device's direct backend: the kernel on the card."""
    return "cuda" if device.type == "cuda" else "torch"


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    out = Path("build") / "verify_frame.ppm"
    if "--out" in argv:
        i = argv.index("--out")
        out = Path(argv[i + 1])
        del argv[i:i + 2]
    n = int(argv[0]) if len(argv) > 0 else 6000
    steps = int(argv[1]) if len(argv) > 1 else 2000

    # 1. scene -> world -> update -> particles -> render
    scene = nt.make_galaxies(n, 3, seed=SEED)
    w = nt.create_world(scene, device=device)
    w.update(0.01, steps)
    p = w.particles
    if not torch.isfinite(p.pos).all():
        raise AssertionError(f"NaNs after {steps} steps")
    cam = fit_camera(p.pos, 640, 360)
    frame = render_frame(w.state, cam)
    lit = int((frame.sum(axis=-1) > 0).sum())
    if frame.shape != (360, 640, 3) or lit <= 100:
        raise AssertionError(f"frame {frame.shape}, {lit} lit pixels")
    out.parent.mkdir(parents=True, exist_ok=True)
    save_ppm(str(out), frame)
    print(f"drive: N={n} x {steps} steps OK; frame lit px={lit}", flush=True)

    # 2. probes
    try:
        nt.make_galaxies(150, 2)
        raise SystemExit("FAIL: min-100-per-galaxy validation missing")
    except ValueError:
        print("probe: make_galaxies(150, 2) ValueError OK", flush=True)

    drift = nt.create_world(nt.make_particles(
        pos=[[0.0, 0.0], [10.0, 0.0]], vel=[[1.0, 0.0], [0.0, 1.0]],
        mass=[0.0, 0.0], radius=[0.5, 0.5]), device=device)
    p0 = drift.particles.pos.clone()
    drift.update(0.25, 8)
    if not torch.equal(drift.particles.acc, torch.zeros_like(p0)):
        raise AssertionError("massless world: nonzero acceleration")
    drift.update(-0.25, 8)
    np.testing.assert_allclose(drift.particles.pos.numpy(), p0.numpy(),
                               atol=1e-5)
    print("probe: massless pure drift + exact reverse OK", flush=True)

    solo = nt.create_world(nt.make_particles(
        pos=[[3.0, 4.0]], vel=[[0.0, 0.0]], mass=[5.0], radius=[1.0]),
        device=device)
    solo.update(0.1, 50)
    np.testing.assert_allclose(solo.particles.pos.numpy(), [[3.0, 4.0]],
                               atol=1e-6)
    print("probe: single-particle self-interaction zero OK", flush=True)

    kernel = direct_backend(device)
    mixed = nt.create_world(scene, device=device)
    ref = nt.create_world(scene, device=device)
    for i in range(6):
        mixed.update(0.01, 5, backend="torch" if i % 2 else kernel)
    ref.update(0.01, 30, backend="torch")
    a, b = mixed.particles.pos.numpy(), ref.particles.pos.numpy()
    err = float(np.abs(a - b).max() / np.abs(b).max())
    if not err < MIX_BOUND:
        raise AssertionError(f"backend-mix divergence {err:.2e}")
    print(f"probe: torch/{kernel} mid-run mix consistent (rel {err:.1e}) OK",
          flush=True)
    print("verify_drive: ALL OK", flush=True)
    return {"n": n, "steps": steps, "lit": lit, "frame": str(out),
            "mix_err": err, "mix": ("torch", kernel), "world": w}


if __name__ == "__main__":
    main()
