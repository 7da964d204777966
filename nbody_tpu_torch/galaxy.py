"""Procedural spiral-galaxy scene generator (numpy), for the PyTorch port.

A copy of ``nbody_tpu/galaxy.py``: for the same seed it gives bitwise the
same float32 arrays as ``nbody_tpu.make_galaxies``; only the returned
container holds CPU tensors. The original's description follows.

Reimplements the reference's ``src/lib/galaxy.c:31-221`` algorithm (same
distributions and constants from ``include/galaxy.h:10-61``) on top of
``numpy.random.Generator``. This production generator matches the
reference's *distributions*, not its libc ``rand()`` bitstream — golden
scenes are defined by our seeds. (The bitstream itself IS reproduced by the
separate parity oracle ``models/galaxy_ref.make_galaxies_libc``, which this
generator is cross-validated against at the distribution level in
tests/test_generator_crossval.py; structural invariants in
tests/test_galaxy.py; the port's copy in tests/test_torch_types_galaxy.py.)

Generation is one-shot O(N) host work (the reference's is too), so it stays in
numpy; the per-particle synthesis loop (galaxy.c:179-216) is vectorized.
"""

from __future__ import annotations

import numpy as np

from .types import DEFAULT_GALAXY_CONFIG, G, GalaxyConfig, Particles, make_particles


def make_galaxies(
    particle_count: int,
    galaxy_count: int,
    *,
    seed: int | np.random.Generator = 0,
    config: GalaxyConfig = DEFAULT_GALAXY_CONFIG,
) -> Particles:
    """Generate ``particle_count`` particles arranged in ``galaxy_count``
    spiral galaxies (MakeGalaxies, galaxy.h:64).

    Each galaxy: a heavy core (radius ~ U[200,600), mass = (4*pi*rho/3) r^3),
    2-4 Archimedean spiral arms of particles with orbital velocity
    sqrt(G*M_core/d), distance-proportional probability of massless tracers,
    and rejection-sampled placement around a random parent galaxy with a
    tangential inter-core velocity kick.
    """
    cfg = config
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    if particle_count < galaxy_count * cfg.min_particles_per_galaxy:
        raise ValueError(
            f"need at least {galaxy_count * cfg.min_particles_per_galaxy} particles "
            f"to make {galaxy_count} galaxies, called with {particle_count}"
        )
    if galaxy_count < 1:
        raise ValueError("galaxy_count must be >= 1")

    two_pi = 2.0 * cfg.pi

    # --- particle budget per galaxy (galaxy.c:42-65) ---
    rand_range = particle_count - galaxy_count * cfg.min_particles_per_galaxy
    sizes = np.empty(galaxy_count, dtype=np.int64)
    for i in range(galaxy_count):
        if i == galaxy_count - 1:
            extra = rand_range
        else:
            extra = int(rng.integers(0, 1 + rand_range))
            rand_range -= extra
        sizes[i] = cfg.min_particles_per_galaxy + extra
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    # --- cores and galaxy radii (galaxy.c:68-79) ---
    core_radius = np.empty(galaxy_count, dtype=np.float64)
    min_dist = np.empty(galaxy_count, dtype=np.float64)
    max_dist = np.empty(galaxy_count, dtype=np.float64)
    for i in range(galaxy_count):
        r = rng.uniform(cfg.gc_min_r, cfg.gc_max_r)
        core_radius[i] = r
        min_dist[i] = r * cfg.min_particle_dist_cr_f
        max_dist[i] = r * cfg.max_particle_dist_cr_f + np.sqrt(float(sizes[i])) * cfg.max_particle_dist_pc_f
    core_mass = np.asarray(cfg.r_to_m(core_radius, cfg.gc_density))

    # --- rejection-sampled placement (galaxy.c:82-118); galaxy 0 at origin ---
    core_pos = np.zeros((galaxy_count, 2), dtype=np.float64)
    for i in range(1, galaxy_count):
        while True:
            parent = int(rng.integers(0, i))
            min_sep = cfg.min_galaxy_separation * (max_dist[i] + max_dist[parent])
            max_sep = cfg.max_galaxy_separation * (max_dist[i] + max_dist[parent])
            dist = np.sqrt(rng.uniform(min_sep * min_sep, max_sep * max_sep))
            angle = rng.uniform(0.0, two_pi)
            cand = core_pos[parent] + dist * np.array([np.cos(angle), np.sin(angle)])
            collision = False
            for j in range(i):
                if j == parent:
                    continue
                other_min_sep = cfg.min_galaxy_separation * (max_dist[i] + max_dist[j])
                if np.sum((cand - core_pos[j]) ** 2) < other_min_sep * other_min_sep:
                    collision = True
                    break
            if not collision:
                core_pos[i] = cand
                break

    # --- tangential velocity kicks between every core pair (galaxy.c:121-142) ---
    core_vel = np.zeros((galaxy_count, 2), dtype=np.float64)
    for i in range(1, galaxy_count):
        for j in range(i):
            a_to_b = core_pos[j] - core_pos[i]
            dist = float(np.hypot(*a_to_b))
            unit = a_to_b / dist
            speed_a = 0.3 * np.sqrt(G * core_mass[j] / dist)
            speed_b = 0.3 * np.sqrt(G * core_mass[i] / dist)
            core_vel[i] += speed_a * np.array([unit[1], -unit[0]])
            core_vel[j] += speed_b * np.array([-unit[1], unit[0]])

    # --- per-galaxy particle synthesis (galaxy.c:146-216), vectorized ---
    pos = np.zeros((particle_count, 2), dtype=np.float64)
    vel = np.zeros((particle_count, 2), dtype=np.float64)
    mass = np.zeros(particle_count, dtype=np.float64)
    radius = np.zeros(particle_count, dtype=np.float64)

    for i in range(galaxy_count):
        o, sz = int(offsets[i]), int(sizes[i])
        # index o is the core itself
        pos[o] = core_pos[i]
        vel[o] = core_vel[i]
        mass[o] = core_mass[i]
        radius[o] = core_radius[i]

        m = sz - 1  # number of non-core particles
        if m == 0:
            continue

        # spiral arm layout (galaxy.c:153-176)
        initial_offset = rng.uniform(0.0, two_pi)
        spiral_count = int(rng.integers(cfg.min_spirals, cfg.max_spirals + 1))
        spiral_angle_dist = two_pi / spiral_count
        spiral_offsets = initial_offset + np.arange(spiral_count) * spiral_angle_dist

        # Archimedean spiral r(t) = b*t spanning [min_dist, max_dist]
        t1 = two_pi
        b = max_dist[i] / t1
        t0 = min_dist[i] / b

        t = rng.uniform(t0, t1, size=m)
        r = b * t
        # non-uniform jitter keeps arms coherent (galaxy.c:164-171)
        t_off = rng.uniform(0.0, 0.6 * np.sqrt(spiral_angle_dist), size=m)
        # clamp to 0: r = b*t can land 1 ulp below min_dist when t ~ t0
        # (matches cpp/galaxy_gen.cpp fmax and models/galaxy_device.py maximum)
        r_off = rng.uniform(
            0.0, 0.6 * np.sqrt(np.maximum(np.minimum(b, r - min_dist[i]), 0.0)), size=m
        )
        r_sign = np.where(rng.integers(0, 2, size=m) == 1, 1.0, -1.0)
        t_sign = np.where(rng.integers(0, 2, size=m) == 1, 1.0, -1.0)
        dist = r + r_sign * r_off * r_off
        ang = t + t_sign * t_off * t_off

        arm = spiral_offsets[rng.integers(0, spiral_count, size=m)]
        dx = dist * np.cos(ang + arm)
        dy = dist * np.sin(ang + arm)
        p = slice(o + 1, o + sz)
        pos[p, 0] = core_pos[i, 0] + dx
        pos[p, 1] = core_pos[i, 1] + dy

        # distance-proportional massless tracers (galaxy.c:204-210)
        dist_range = max_dist[i] - min_dist[i]
        massless = rng.uniform(0.0, 1.0, size=m) < (dist - min_dist[i]) / dist_range
        body_r = rng.uniform(cfg.np_min_r, cfg.np_max_r, size=m)
        radius[p] = np.where(massless, cfg.tracer_radius, body_r)
        mass[p] = np.where(massless, 0.0, cfg.r_to_m(body_r, cfg.np_density))

        # circular orbital velocity around the core (galaxy.c:213-215)
        speed = np.sqrt(G * core_mass[i] / dist)
        vel[p, 0] = core_vel[i, 0] + speed * (dy / dist)
        vel[p, 1] = core_vel[i, 1] + speed * (-dx / dist)

    return make_particles(
        pos.astype(np.float32),
        vel=vel.astype(np.float32),
        mass=mass.astype(np.float32),
        radius=radius.astype(np.float32),
    )
