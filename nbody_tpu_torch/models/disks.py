"""Kepler-disk and cold-collapse scene families, drawn on the scene's device.

Counterpart of ``nbody_tpu/models/disks.py``; the reference has neither:

* **Kepler disk**: one dominant central mass (row 0) plus a ring of light
  bodies on circular orbits: the accuracy probe for the approximate
  backends and the stage for collision merging.
* **Cold disk**: a uniform disk of equal masses at rest: gravitational
  collapse, the stress test for adaptive timestepping.

Both are all-massive (``mass_len == N``). The draws follow ``nbody_tpu``'s
order through :class:`~nbody_tpu_torch.models.draws.Draws`; the streams
differ (see there), so a seed gives another scene than ``nbody_tpu``'s,
and on the card another than on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..forces import sqrt
from ..types import DTYPE, G, Particles
from .draws import _f32, draws_for


def make_kepler_disk(
    generator,
    n: int,
    *,
    central_mass: float = 1.0e7,
    central_radius: float = 10.0,
    body_mass: float = 1.0,
    body_radius: float = 0.5,
    r_min: float = 200.0,
    r_max: float = 1200.0,
    eccentricity_jitter: float = 0.0,
    device="cuda",
) -> Particles:
    """Central body (row 0) + ``n - 1`` light bodies on circular orbits.

    ``generator`` as in :func:`~nbody_tpu_torch.models.plummer.make_plummer_disk`.
    Radii have a uniform surface density over the annulus (r ~ sqrt(U));
    each body moves at v = sqrt(G M_c / r); ``eccentricity_jitter`` adds a
    fractional random velocity (drawn even when it is 0, as ``nbody_tpu``
    draws it, so the order of the draws never changes). The central body
    takes the opposite of the disk's momentum."""
    draws = draws_for(generator, device)
    dev = draws.device
    m = n - 1
    u = draws.uniform((m,))
    r = sqrt(r_min**2 + u * (r_max**2 - r_min**2))
    theta = draws.uniform((m,), 0.0, 2.0 * math.pi)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    pos = r[:, None] * torch.stack([cos_t, sin_t], dim=1)

    speed = sqrt(G * central_mass / r)
    vel = speed[:, None] * torch.stack([-sin_t, cos_t], dim=1)
    vel = vel + (_f32(eccentricity_jitter, dev) * speed[:, None]
                 * draws.normal((m, 2)))

    zero = torch.zeros((1, 2), dtype=DTYPE, device=dev)
    pos = torch.cat([zero, pos])
    vel = torch.cat([zero, vel])
    mass = torch.cat([torch.full((1,), central_mass, dtype=DTYPE, device=dev),
                      torch.full((m,), body_mass, dtype=DTYPE, device=dev)])
    radius = torch.cat([
        torch.full((1,), central_radius, dtype=DTYPE, device=dev),
        torch.full((m,), body_radius, dtype=DTYPE, device=dev)])
    # zero net momentum: the central body takes the opposite of the disk's
    # (an fp32 sum, whose last bits depend on its order)
    disk_mom = torch.sum(mass[1:, None] * vel[1:], dim=0)
    vel = torch.cat([(-disk_mom / central_mass)[None], vel[1:]])
    return Particles(pos=pos, vel=vel,
                     acc=torch.zeros((n, 2), dtype=DTYPE, device=dev),
                     mass=mass, radius=radius)


def make_cold_disk(
    generator,
    n: int,
    *,
    total_mass: float = 1.0e7,
    extent: float = 800.0,
    particle_radius: float = 2.0,
    device="cuda",
) -> Particles:
    """Uniform-density disk of equal masses at rest (cold collapse).

    ``generator`` as in :func:`~nbody_tpu_torch.models.plummer.make_plummer_disk`.
    Positions uniform over a disk of radius ``extent`` (r ~ sqrt(U)); zero
    velocity everywhere, so the total momentum is exactly zero."""
    draws = draws_for(generator, device)
    dev = draws.device
    r = extent * sqrt(draws.uniform((n,)))
    theta = draws.uniform((n,), 0.0, 2.0 * math.pi)
    pos = r[:, None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)

    def full(value):
        return torch.full((n,), value, dtype=DTYPE, device=dev)

    return Particles(
        pos=pos,
        vel=torch.zeros((n, 2), dtype=DTYPE, device=dev),
        acc=torch.zeros((n, 2), dtype=DTYPE, device=dev),
        mass=full(total_mass / n),
        radius=full(particle_radius),
    )
