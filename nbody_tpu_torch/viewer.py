"""Headless animation export. Counterpart of the headless part of
``nbody_tpu/viewer.py`` (``PHYS_STEP`` and ``export_animation``); the
interactive viewer is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .render import Camera, fit_camera, rasterize
from .types import DTYPE

# The reference's fixed physics step (main.c:140-163).
PHYS_STEP = 0.01


def export_animation(world, path: str, frames: int = 100,
                     steps_per_frame: int = 4, dt: float = PHYS_STEP,
                     width: int = 640, height: int = 360,
                     camera: Camera | None = None, backend: str | None = None,
                     fps: int = 25) -> None:
    """Simulate and rasterize on the world's device, frame by frame; the
    uint8 frames are stacked there and read back once. ``path`` ending in
    .npz saves the raw frames (``frames``: (F, H, W, 3) uint8); any other
    path writes an animated GIF through PIL, imported only then."""
    if camera is None:
        camera = fit_camera(world.particles.pos, width, height)
    device = world.state.pos.device
    center = torch.tensor([camera.center_x, camera.center_y], dtype=DTYPE,
                          device=device)
    zoom = torch.tensor(camera.zoom, dtype=DTYPE, device=device)
    images = []
    for _ in range(frames):
        world.update(dt, steps_per_frame, backend=backend)
        st = world.state.slice_to(world.total_len)
        images.append(rasterize(st.pos, st.radius, st.mass, center, zoom,
                                width=camera.width, height=camera.height))
    arr = torch.stack(images).cpu().numpy()
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=arr)
        return
    from PIL import Image

    pil = [Image.fromarray(im) for im in arr]
    pil[0].save(path, save_all=True, append_images=pil[1:],
                duration=int(1000 / fps), loop=0)
