"""Plummer-disk scene family, drawn on the scene's device.

Counterpart of ``nbody_tpu/models/plummer.py``: a self-gravitating 2D disk
of equal masses (so ``mass_len == N``, the all-massive stress case for the
force kernels), radius drawn from the projected Plummer distribution, each
particle given the circular speed of the enclosed mass plus a 5% isotropic
jitter. The reference has no counterpart.

The draws follow ``nbody_tpu``'s order (radius parameter, angle, jitter)
through :class:`~nbody_tpu_torch.models.draws.Draws`; the streams differ
(see there), so the same seed gives another scene than ``nbody_tpu``'s,
and on the card another than on the CPU.
"""

from __future__ import annotations

import math

import torch

from ..forces import sqrt
from ..types import DTYPE, G, Particles
from .draws import _f32, draws_for


def make_plummer_disk(
    generator,
    n: int,
    *,
    scale: float = 400.0,
    total_mass: float = 1.0e7,
    particle_radius: float = 2.0,
    r_max_scales: float = 8.0,
    device="cuda",
) -> Particles:
    """Equal-mass Plummer disk of n particles, on the generator's device.

    ``generator`` is an int seed (a new generator on ``device``, "cuda"
    unless given; without a card that raises), a ``torch.Generator`` (its
    own device) or a :class:`~nbody_tpu_torch.models.draws.Draws`.

    Radius CDF (2D projected Plummer): r = a * sqrt(u / (1 - u)) for u ~
    U[0, u_max), truncated at ``r_max_scales * scale``; circular velocity
    from the enclosed mass M(<r) = M_tot r³ / (r² + a²)^{3/2} of the 3D
    Plummer sphere. Every field is fp32; the rows are unsorted."""
    draws = draws_for(generator, device)
    dev = draws.device
    a = _f32(scale, dev)

    u_max = 1.0 - 1.0 / (1.0 + r_max_scales**2)
    u = draws.uniform((n,), 0.0, u_max)
    r = a * sqrt(u / (1.0 - u))
    theta = draws.uniform((n,), 0.0, 2.0 * math.pi)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    pos = r[:, None] * torch.stack([cos_t, sin_t], dim=1)

    enclosed = total_mass * (r * r * r) / (r * r + a * a) ** 1.5
    speed = sqrt(G * enclosed / torch.clamp(r, min=1e-3))
    jitter = 0.05 * speed[:, None] * draws.normal((n, 2))
    vel = speed[:, None] * torch.stack([-sin_t, cos_t], dim=1) + jitter

    return Particles(
        pos=pos,
        vel=vel,
        acc=torch.zeros((n, 2), dtype=DTYPE, device=dev),
        mass=torch.full((n,), total_mass / n, dtype=DTYPE, device=dev),
        radius=torch.full((n,), particle_radius, dtype=DTYPE, device=dev),
    )
