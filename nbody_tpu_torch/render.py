"""Headless rendering on the state's device: particles -> RGB framebuffer.

Counterpart of ``nbody_tpu/render.py`` (the reference's raylib draw path,
``src/main.c:237-250``, without its per-frame readback of the particles).
Rasterization is an integer scatter-max of class ids into a framebuffer on
the device and a palette lookup; only the uint8 image crosses to the host.

The same visual semantics as ``nbody_tpu``, and the same bytes:
  * mass-class colouring (main.c:227-235): massless tracers, normal bodies,
    galaxy cores, with the reference's palette (main.c:20-23);
  * minimum on-screen radius 0.5 pixels (main.c:172, 241-249), each disk a
    fixed stamp of at most ``stamp``² pixels;
  * the camera fitted to the particles' bounding box (main.c:198-225).
Pixel coordinates stay fp32 in JAX's order of operations, ``torch.round``
rounds half to even as ``jnp.round`` does, and the float-to-int32
conversion saturates with NaN to 0 as XLA's does, so a frame is equal byte
for byte to ``nbody_tpu``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .types import DEFAULT_GALAXY_CONFIG, DTYPE, Particles

# Reference palette (main.c:20-23): background, core, normal, massless.
BG_COLOR = (22, 22, 22)
CC_COLOR = (222, 222, 222)
NP_COLOR = (175, 195, 175)
EP_COLOR = (145, 145, 233)

# Class ids used during rasterization; higher id wins on overlap
# (0 = empty background).
_CLASS_COLORS = np.array([BG_COLOR, EP_COLOR, NP_COLOR, CC_COLOR],
                         dtype=np.uint8)

# The largest fp32 below 2**31: float -> int32 saturates here.
_INT32_TOP = 2147483520.0


@dataclass(frozen=True)
class Camera:
    """2D camera: world-space center, zoom (pixels per world unit)."""

    center_x: float
    center_y: float
    zoom: float
    width: int = 1280
    height: int = 720


def fit_camera(pos, width: int = 1280, height: int = 720,
               fill: float = 0.9) -> Camera:
    """Camera fitted to the particles' bounding box (main.c:198-225): the
    zoom shrinks to fit and never enlarges past 1.0; the target is the
    box's midpoint. ``pos`` is a numpy array or a tensor (read to the
    host)."""
    pos = torch.as_tensor(pos).cpu().numpy()
    if pos.shape[0] == 0:
        return Camera(0.0, 0.0, 1.0, width, height)
    mn = pos.min(axis=0)
    mx = pos.max(axis=0)
    span = np.maximum(mx - mn, 1e-6)
    zoom_x = fill * width / span[0]
    zoom_y = fill * height / span[1]
    zoom = 1.0
    if zoom_x < 1.0 or zoom_y < 1.0:
        zoom = float(min(zoom_x, zoom_y))
    c = 0.5 * (mn + mx)
    return Camera(float(c[0]), float(c[1]), zoom, width, height)


def classify_mass(mass: torch.Tensor,
                  min_core_mass: float | None = None) -> torch.Tensor:
    """ColorForMass classes (main.c:227-235): 1 massless, 2 normal, 3 core,
    as int32 on ``mass``'s device."""
    if min_core_mass is None:
        min_core_mass = DEFAULT_GALAXY_CONFIG.min_gc_mass
    return torch.where(mass <= 0, 1,
                       torch.where(mass < min_core_mass, 2, 3)).to(torch.int32)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: NaN to 0, saturating at the int32
    range (a plain ``.to(torch.int32)`` is undefined out of range)."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -2147483648.0, _INT32_TOP).to(torch.int32)


def rasterize(pos: torch.Tensor, radius: torch.Tensor, mass: torch.Tensor,
              center: torch.Tensor, zoom: torch.Tensor, *, width: int = 1280,
              height: int = 720, stamp: int = 7,
              min_core_mass: float | None = None) -> torch.Tensor:
    """(H, W, 3) uint8 framebuffer on the particles' device. ``center`` is a
    (2,) and ``zoom`` a 0-dim fp32 tensor on that device.

    Each particle is a disk of pixel radius ``max(radius · zoom, 0.5)``
    clamped to ``stamp // 2`` + 0.5, splatted with a fixed stamp; overlaps
    resolve by class priority (core > normal > massless): a scatter-max of
    the class id."""
    device = pos.device
    cls = classify_mass(mass, min_core_mass)
    # world -> pixel
    px = (pos[:, 0] - center[0]) * zoom + width / 2.0
    py = (pos[:, 1] - center[1]) * zoom + height / 2.0
    pr = torch.clamp(radius * zoom, min=0.5)  # min on-screen radius (main.c:172)

    half = stamp // 2
    offs = torch.arange(-half, half + 1, dtype=torch.int32, device=device)
    ox, oy = torch.meshgrid(offs, offs, indexing="ij")
    ox = ox.reshape(-1)  # (stamp²,)
    oy = oy.reshape(-1)

    ix = _to_int32(torch.round(px))[:, None] + ox[None, :]
    iy = _to_int32(torch.round(py))[:, None] + oy[None, :]
    # inside-disk mask (pixel-center distance), clamped to the stamp
    d2 = ox[None, :].to(DTYPE) ** 2 + oy[None, :].to(DTYPE) ** 2
    rr = torch.clamp(pr, max=float(half) + 0.5)[:, None]
    inside = d2 <= rr * rr
    inbounds = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    ok = inside & inbounds

    flat_idx = torch.where(ok, iy * width + ix, 0)
    vals = torch.where(ok, cls[:, None], 0)

    grid = torch.zeros(height * width, dtype=torch.int32, device=device)
    grid.scatter_reduce_(0, flat_idx.reshape(-1).to(torch.int64),
                         vals.reshape(-1), reduce="amax")
    palette = torch.from_numpy(_CLASS_COLORS).to(device)
    return palette[grid.to(torch.int64)].reshape(height, width, 3)


def render_frame(particles: Particles, camera: Camera | None = None,
                 **kw) -> np.ndarray:
    """Rasterize ``particles`` (tensors on any one device, or arrays) and
    read the frame back: a host (H, W, 3) uint8 array."""
    pos = torch.as_tensor(particles.pos, dtype=DTYPE)
    device = pos.device
    if camera is None:
        camera = fit_camera(pos, kw.pop("width", 1280), kw.pop("height", 720))
    img = rasterize(
        pos,
        torch.as_tensor(particles.radius, dtype=DTYPE, device=device),
        torch.as_tensor(particles.mass, dtype=DTYPE, device=device),
        torch.tensor([camera.center_x, camera.center_y], dtype=DTYPE,
                     device=device),
        torch.tensor(camera.zoom, dtype=DTYPE, device=device),
        width=camera.width, height=camera.height, **kw)
    return img.cpu().numpy()


def save_ppm(path: str, img) -> None:
    """Dependency-free image export (binary PPM)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
