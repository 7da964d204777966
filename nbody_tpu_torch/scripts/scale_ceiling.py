"""One-card scale ceiling: the particle-mesh backend at N=32M.

Counterpart of ``scripts/scale_ceiling.py``: the scene is drawn on the
device (``models.make_galaxies_device``: a 32M-particle host scene would
cost a minute of numpy and a 1 GiB upload), the world is created there
with ``default_backend="pm"``, and after one warm-up substep
``update(dt, substeps)`` is timed with CUDA events, giving ms a substep and
particle-updates a second. Memory is ``torch.cuda.max_memory_allocated()``
against the card's total (``torch.cuda.mem_get_info()``). The "pm" path
launches no hand-written kernel, so nothing is built.

Usage: python -m nbody_tpu_torch.scripts.scale_ceiling [N] [grid]
       [substeps] [--device cpu]
Defaults N=33554432, grid=2048, substeps=8.
"""

from __future__ import annotations

import sys
import time

import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.scripts.validate_physics import SEED, sync, timed
from nbody_tpu_torch.types import SimConfig

DT = 0.005


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    n = int(argv[0]) if len(argv) > 0 else 32 * 1024 * 1024
    grid = int(argv[1]) if len(argv) > 1 else 2048
    steps = int(argv[2]) if len(argv) > 2 else 8
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    scene = nt.make_galaxies_device(SEED, n, 2, device=device)
    sync(device)
    scene_s = time.perf_counter() - t0
    print(f"scene on device: N={n} in {scene_s:.1f}s", flush=True)

    t0 = time.perf_counter()
    world = nt.create_world(scene, config=SimConfig(pm_grid=grid),
                            default_backend="pm", device=device)
    world.block_until_ready()
    world_s = time.perf_counter() - t0
    print(f"world created in {world_s:.1f}s (massive={world.mass_len})",
          flush=True)

    world.update(DT, 1)  # warm-up: cuFFT plans, allocator
    wall_s, dev_ms = timed(lambda: world.update(DT, steps), device)
    per = (dev_ms if device.type == "cuda" else wall_s * 1e3) / steps
    print(f"pm N={n} grid={grid}: {per:.0f} ms/substep "
          f"({n / per * 1e3 / 1e6:.0f}M particle-updates/s)", flush=True)

    if not bool(torch.isfinite(world.state.pos).all()):
        raise AssertionError("non-finite state")
    peak_gib = total_gib = float("nan")
    if device.type == "cuda":
        peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
        total_gib = torch.cuda.mem_get_info(device)[1] / 2 ** 30
        print(f"memory: peak {peak_gib:.2f} GiB / limit {total_gib:.2f} GiB",
              flush=True)
    else:
        print("memory: not measured on the CPU", flush=True)
    print("OK", flush=True)
    return {"n": n, "grid": grid, "substeps": steps, "scene": scene,
            "world": world, "mass_len": world.mass_len, "scene_s": scene_s,
            "world_s": world_s, "ms": per, "wall_ms": wall_s * 1e3 / steps,
            "updates_per_s": n / per * 1e3, "peak_gib": peak_gib,
            "total_gib": total_gib}


if __name__ == "__main__":
    main()
