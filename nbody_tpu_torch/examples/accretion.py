"""Accretion demo: a cold dense cluster collapses and merges into a few
bodies under opt-in inelastic collision merging (SimConfig.merge_collisions;
the contact search is the hand-written kernel csrc/merge_contacts.cu).

Usage: python -m nbody_tpu_torch.examples.accretion [n] [steps] [out.gif]
       [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.types import SimConfig, make_particles


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    n = int(argv[0]) if len(argv) > 0 else 400
    steps = int(argv[1]) if len(argv) > 1 else 2000
    out = argv[2] if len(argv) > 2 else None

    rng = np.random.default_rng(11037)
    half = 2.0 * np.sqrt(n)  # n-invariant density: a few bodies overlap at t=0
    scene = make_particles(
        rng.uniform(-half, half, (n, 2)).astype(np.float32),
        vel=rng.normal(0, 0.5, (n, 2)).astype(np.float32),
        mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
        radius=np.full(n, 0.8, np.float32),
    )
    world = nt.create_world(scene, config=SimConfig(merge_collisions=True),
                            device=device)
    m0 = float(scene.mass.sum())

    if out:
        from nbody_tpu_torch.viewer import export_animation

        # per-frame world.update goes through the same merging substep loop
        export_animation(world, out, frames=40,
                         steps_per_frame=max(steps // 40, 1), dt=0.01,
                         width=480, height=480)
    else:
        world.update(0.01, steps)

    p = world.particles
    survivors = int((p.mass > 0).sum())
    print(f"N={n}: {survivors} massive bodies survive after {steps} substeps "
          f"({n - survivors} mergers); mass conserved: "
          f"{float(p.mass.sum()):.4f} / {m0:.4f}")
    if abs(float(p.mass.sum()) - m0) >= 1e-3 * m0:
        raise SystemExit("accretion: mass not conserved")
    if out:
        print(f"wrote {out}")
    return {"world": world, "survivors": survivors}


if __name__ == "__main__":
    globals().update(main())
