"""Spiral-galaxy scenes drawn on the device, with no host sync.

Counterpart of ``nbody_tpu/models/galaxy_device.py`` (reference
``src/lib/galaxy.c:31-221``, constants ``include/galaxy.h:10-61``): the
host generator (``nbody_tpu_torch.galaxy``) walks the reference algorithm
in numpy; this one draws every particle with vectorized PyTorch on the
scene's device, so a scene of 10⁶ particles is made on the card without
crossing the host. The per-galaxy scaffolding unrolls over the static
``galaxy_count``:

* particle budget: Dirichlet(1, ..., 1) fractions of the spare particles,
  the rounding remainder to the last galaxy (galaxy.c:48-50);
* cores: radius ~ U[200, 600), mass = (4 pi rho / 3) r³;
* placement (galaxy.c:82-118): ``nbody_tpu`` tries a candidate (a parent
  galaxy, a distance, an angle) and then up to ``MAX_PLACEMENT_TRIES``
  more while it collides with a galaxy placed before, other than its
  parent; here all the candidates are drawn at once and the first that
  does not collide is taken (the last one if all collide), on the device;
* tangential velocity kicks between cores (galaxy.c:121-142), O(G²)
  scalar terms in ``nbody_tpu``'s order;
* particles, vectorized: spiral parameter, angular and radial jitter, arm,
  the distance-proportional massless rule, circular orbital velocity.

The draws follow ``nbody_tpu``'s order through
:class:`~nbody_tpu_torch.models.draws.Draws`; the streams differ (see
there), so a seed gives another scene than ``nbody_tpu``'s, and on the
card another than on the CPU: they match in distribution.
"""

from __future__ import annotations

import torch

from ..forces import sqrt
from ..types import DEFAULT_GALAXY_CONFIG, DTYPE, G, GalaxyConfig, Particles
from .draws import draws_for

MAX_PLACEMENT_TRIES = 256


def _place_galaxy(draws, i: int, core_pos, max_dist, cfg: GalaxyConfig):
    """The position of galaxy i, given galaxies [0, i) (galaxy.c:82-118):
    the first of 1 + MAX_PLACEMENT_TRIES candidates that collides with no
    prior galaxy but its parent, else the last candidate."""
    tries = MAX_PLACEMENT_TRIES + 1
    parent = draws.randint((tries,), 0, i)
    sep_scale = max_dist[i] + max_dist[parent]
    min_sep = cfg.min_galaxy_separation * sep_scale
    max_sep = cfg.max_galaxy_separation * sep_scale
    dist = sqrt(draws.uniform((tries,), min_sep * min_sep, max_sep * max_sep))
    ang = draws.uniform((tries,), 0.0, 2.0 * cfg.pi)
    cand = core_pos[parent] + dist[:, None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], dim=1)
    # collision of each candidate against all prior galaxies except its parent
    idx = torch.arange(core_pos.shape[0], device=core_pos.device)
    prior = (idx < i)[None, :] & (idx[None, :] != parent[:, None])
    min_seps = cfg.min_galaxy_separation * (max_dist[i] + max_dist)
    diff = core_pos[None, :, :] - cand[:, None, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    free = ~torch.any(prior & (d2 < min_seps * min_seps), dim=1)
    first = torch.where(free.any(), torch.argmax(free.to(torch.int32)),
                        tries - 1)
    # index_select: a 0-dim index tensor would be read back to the host
    return cand.index_select(0, first.reshape(1))[0]


def make_galaxies_device(
    generator,
    particle_count: int,
    galaxy_count: int,
    cfg: GalaxyConfig = DEFAULT_GALAXY_CONFIG,
    *,
    device="cuda",
) -> Particles:
    """A spiral-galaxy scene of exactly ``particle_count`` rows drawn on the
    generator's device (unsorted; feed it to ``create_world``).

    ``generator`` is an int seed (a new generator on ``device``, "cuda"
    unless given; without a card that raises), a ``torch.Generator`` (its
    own device) or a :class:`~nbody_tpu_torch.models.draws.Draws`. On the
    card nothing is read back to the host."""
    if particle_count < galaxy_count * cfg.min_particles_per_galaxy:
        raise ValueError(
            f"need at least {galaxy_count * cfg.min_particles_per_galaxy} "
            f"particles for {galaxy_count} galaxies, got {particle_count}")
    draws = draws_for(generator, device)
    dev = draws.device
    two_pi = 2.0 * cfg.pi
    g = galaxy_count

    # --- budget (normalized fractions; min 100 each) ---
    spare = particle_count - g * cfg.min_particles_per_galaxy
    frac = draws.dirichlet_ones(g)
    extras = torch.floor(frac * spare).to(torch.int64)
    extras = torch.cat([extras[:-1], extras[-1:] + (spare - extras.sum())])
    sizes = cfg.min_particles_per_galaxy + extras
    offsets = torch.cumsum(sizes, 0) - sizes

    # --- cores (galaxy.c:68-79) ---
    core_radius = draws.uniform((g,), cfg.gc_min_r, cfg.gc_max_r)
    min_dist = core_radius * cfg.min_particle_dist_cr_f
    max_dist = (core_radius * cfg.max_particle_dist_cr_f
                + sqrt(sizes.to(DTYPE)) * cfg.max_particle_dist_pc_f)
    core_mass = cfg.r_to_m(core_radius, cfg.gc_density)

    # --- placement (galaxy 0 at the origin) ---
    core_pos = torch.zeros((g, 2), dtype=DTYPE, device=dev)
    for i in range(1, g):
        core_pos = core_pos.clone()
        core_pos[i] = _place_galaxy(draws, i, core_pos, max_dist, cfg)

    # --- tangential velocity kicks (galaxy.c:121-142) ---
    kick = [torch.zeros(2, dtype=DTYPE, device=dev) for _ in range(g)]
    for i in range(1, g):
        for j in range(i):
            a_to_b = core_pos[j] - core_pos[i]
            dist = sqrt(a_to_b[0] * a_to_b[0] + a_to_b[1] * a_to_b[1])
            unit = a_to_b / dist
            speed_a = 0.3 * sqrt(G * core_mass[j] / dist)
            speed_b = 0.3 * sqrt(G * core_mass[i] / dist)
            kick[i] = kick[i] + speed_a * torch.stack([unit[1], -unit[0]])
            kick[j] = kick[j] + speed_b * torch.stack([-unit[1], unit[0]])
    core_vel = torch.stack(kick)

    # --- per-particle synthesis, vectorized over particle_count ---
    n = particle_count
    pidx = torch.arange(n, device=dev)
    # galaxy id of each row; a galaxy's core is the row at its offset
    gal = torch.searchsorted(offsets, pidx, right=True) - 1
    is_core = pidx == offsets[gal]

    # spiral layout per galaxy (galaxy.c:153-176)
    init_off = draws.uniform((g,), 0.0, two_pi)
    spiral_count = draws.randint((g,), cfg.min_spirals, cfg.max_spirals + 1)
    spiral_angle = two_pi / spiral_count.to(DTYPE)
    b = max_dist / two_pi
    t0 = min_dist / b

    b_g, min_g = b[gal], min_dist[gal]
    t = draws.uniform((n,), t0[gal], two_pi)
    r = b_g * t
    t_off = draws.uniform((n,), 0.0, 0.6 * sqrt(spiral_angle[gal]))
    r_off = draws.uniform((n,), 0.0, 0.6 * sqrt(
        torch.clamp(torch.minimum(b_g, r - min_g), min=0.0)))
    one = torch.ones((), dtype=DTYPE, device=dev)
    r_sign = torch.where(draws.bernoulli((n,), 0.5), one, -one)
    t_sign = torch.where(draws.bernoulli((n,), 0.5), one, -one)
    dist = r + r_sign * r_off * r_off
    ang = t + t_sign * t_off * t_off
    arm_idx = draws.randint((n,), 0, spiral_count[gal])
    arm = init_off[gal] + arm_idx.to(DTYPE) * spiral_angle[gal]

    dx = dist * torch.cos(ang + arm)
    dy = dist * torch.sin(ang + arm)
    cpx, cpy = core_pos[:, 0][gal], core_pos[:, 1][gal]
    px = cpx + dx
    py = cpy + dy

    # massless rule (galaxy.c:204-210) + body mass/radius
    dist_range = max_dist[gal] - min_g
    massless = draws.uniform((n,)) < (dist - min_g) / dist_range
    body_r = draws.uniform((n,), cfg.np_min_r, cfg.np_max_r)
    radius = torch.where(massless, cfg.tracer_radius, body_r)
    mass = torch.where(massless, 0.0, cfg.r_to_m(body_r, cfg.np_density))

    # circular orbital velocity around the core (galaxy.c:213-215)
    speed = sqrt(G * core_mass[gal] / dist)
    cvx, cvy = core_vel[:, 0][gal], core_vel[:, 1][gal]
    vx = cvx + speed * (dy / dist)
    vy = cvy - speed * (dx / dist)

    # the core rows take their core's values
    px = torch.where(is_core, cpx, px)
    py = torch.where(is_core, cpy, py)
    vx = torch.where(is_core, cvx, vx)
    vy = torch.where(is_core, cvy, vy)
    mass = torch.where(is_core, core_mass[gal], mass)
    radius = torch.where(is_core, core_radius[gal], radius)

    return Particles(
        pos=torch.stack([px, py], dim=1),
        vel=torch.stack([vx, vy], dim=1),
        acc=torch.zeros((n, 2), dtype=DTYPE, device=dev),
        mass=mass,
        radius=radius,
    )
