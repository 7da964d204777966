"""Million-particle galaxy collision with the particle-mesh far-field
backend (backend="pm": CIC -> FFT convolution -> CIC; O(N + G^2 log G) a
substep).

Usage: python -m nbody_tpu_torch.examples.pm_million [n] [frames] [backend]
       [out.gif] [--device cpu]
``backend`` may be "pm" (default, fastest, approximate near field) or
"p3m" (accurate at all ranges: the mesh far field and the exact
short-range pair correction of the hand-written kernel
csrc/p3m_pp.cu). The p3m run uses ``p3m_rebin_interval=8`` (the cell
sorts made once every 8 substeps). Writes <backend>_million.gif in the
current directory (a path ending in .npz saves the raw frames; the GIF
needs PIL). From N = 8M the scene is drawn on the device.
"""

from __future__ import annotations

import sys
import time

import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.types import SimConfig
from nbody_tpu_torch.viewer import export_animation

SEED = 11037


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    n = int(argv[0]) if len(argv) > 0 else 1_048_576
    frames = int(argv[1]) if len(argv) > 1 else 60
    backend = argv[2] if len(argv) > 2 else "pm"

    if n >= 8_000_000:
        # beyond host-numpy scale: the scene is drawn on the device
        scene = nt.make_galaxies_device(SEED, n, 2, device=device)
    else:
        scene = nt.make_galaxies(n, 2, seed=SEED)
    grid = (2048 if n >= 8_000_000 else 1024) if backend == "pm" else 512
    world = nt.create_world(
        scene, config=SimConfig(pm_grid=grid, p3m_rebin_interval=8),
        default_backend=backend, device=device)
    print(f"N={world.total_len} massive={world.mass_len} "
          f"backend={backend} grid={grid}")

    t0 = time.perf_counter()
    out = argv[3] if len(argv) > 3 else f"{backend}_million.gif"
    export_animation(world, out, frames=frames, steps_per_frame=4, dt=0.005,
                     width=640, height=360)
    dtv = time.perf_counter() - t0
    print(f"{frames} frames x 4 substeps in {dtv:.1f}s "
          f"({dtv / (frames * 4) * 1e3:.0f} ms/substep incl. rendering) "
          f"-> {out}")
    if not torch.isfinite(world.particles.pos).all():
        raise SystemExit("pm_million: non-finite positions")
    return {"world": world, "seconds": dtv}


if __name__ == "__main__":
    globals().update(main())
