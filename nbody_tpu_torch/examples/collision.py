"""Two-galaxy collision, rendered headlessly to an animated GIF.

Usage: python -m nbody_tpu_torch.examples.collision [out.gif] [n] [frames]
       [--device cpu]
The analogue of watching the reference's raylib window (src/main.c), but
all simulation and rasterization stays on the device; only uint8 frames
come back. A path ending in .npz saves the raw frames instead (the GIF
needs PIL).
"""

from __future__ import annotations

import sys

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.render import fit_camera
from nbody_tpu_torch.viewer import export_animation


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    out = argv[0] if len(argv) > 0 else "collision.gif"
    n = int(argv[1]) if len(argv) > 1 else 8000
    frames = int(argv[2]) if len(argv) > 2 else 150

    scene = nt.make_galaxies(n, 2, seed=42)
    world = nt.create_world(scene, device=device)
    print(f"N={world.total_len} massive={world.mass_len} "
          f"backend={world.default_backend}")

    camera = fit_camera(scene.pos, 640, 360)
    export_animation(world, out, frames=frames, steps_per_frame=8, dt=0.01,
                     width=640, height=360, camera=camera)
    print(f"wrote {out}")
    return {"world": world, "camera": camera}


if __name__ == "__main__":
    globals().update(main())
