"""The benchmark's scene: the reference's MakeGalaxies(N, G), frozen.

A copy of ``nbody_tpu_torch/galaxy.py``'s numpy generator as it stood when
the benchmark was defined, kept here so that a change to the program cannot
change the inputs it is measured on. It reimplements the reference's
``src/lib/galaxy.c:31-221`` with ``include/galaxy.h:10-61``'s constants
(Urist-McDeveloper/nbody) on ``numpy.random.Generator``, and returns plain
float32 arrays: for the same seed they are bit-equal to the program's
``make_galaxies`` (``perfbench/tests`` holds them to it).
"""

from __future__ import annotations

import numpy as np

G = 10.0                      # include/nbody.h:8
PI = 3.1415927                # galaxy.h's constants
MIN_SPIRALS, MAX_SPIRALS = 2, 4
GC_MIN_R, GC_MAX_R, GC_DENSITY = 200.0, 600.0, 30.0
NP_MIN_R, NP_MAX_R, NP_DENSITY = 1.5, 9.5, 10.0
MIN_PARTICLES_PER_GALAXY = 100
MIN_PARTICLE_DIST_CR_F = 5.0
MAX_PARTICLE_DIST_CR_F = 10.0
MAX_PARTICLE_DIST_PC_F = 300.0
MIN_GALAXY_SEPARATION, MAX_GALAXY_SEPARATION = 1.4, 2.0
TRACER_RADIUS = 0.5


def rng_of(seed: int) -> np.random.Generator:
    """The generator of ``--seed``: any whole number, folded into 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def deployment(spec: dict, seed: int) -> dict:
    """The configuration's scene for the run's ``seed``: the galaxies of
    ``spec["seed"]`` (the same bodies in every run, so that every seed
    asks the same work of the program), turned by one of the square's
    eight symmetries (rotations by quarter turns, and reflections; exact
    in float32) and with its rows shuffled, both drawn from ``seed``."""
    base = make_galaxies(spec["particles"], spec["galaxies"],
                         rng_of(spec["seed"]))
    rng = rng_of(seed)
    k = int(rng.integers(8))
    perm = rng.permutation(spec["particles"])
    out = {}
    for f in ("pos", "vel"):
        x, y = base[f][:, 0], base[f][:, 1]
        for _ in range(k % 4):
            x, y = -y, x
        if k >= 4:
            x = -x
        out[f] = np.ascontiguousarray(np.stack([x, y], 1)[perm])
    for f in ("mass", "radius"):
        out[f] = base[f][perm]
    return out


def r_to_m(r, density):
    """m = (4 pi rho / 3) r^3 (galaxy.h:21-24)."""
    return (4.0 * PI * density / 3.0) * r * r * r


def make_galaxies(particle_count: int, galaxy_count: int,
                  rng: np.random.Generator) -> dict:
    """``particle_count`` particles in ``galaxy_count`` spiral galaxies:
    {"pos": (N, 2), "vel": (N, 2), "mass": (N,), "radius": (N,)}, float32,
    in generation order (galaxy by galaxy, each core first)."""
    if galaxy_count < 1:
        raise ValueError("galaxy_count must be >= 1")
    if particle_count < galaxy_count * MIN_PARTICLES_PER_GALAXY:
        raise ValueError(f"need at least {galaxy_count * MIN_PARTICLES_PER_GALAXY}"
                         f" particles, got {particle_count}")
    two_pi = 2.0 * PI

    rand_range = particle_count - galaxy_count * MIN_PARTICLES_PER_GALAXY
    sizes = np.empty(galaxy_count, dtype=np.int64)
    for i in range(galaxy_count):
        if i == galaxy_count - 1:
            extra = rand_range
        else:
            extra = int(rng.integers(0, 1 + rand_range))
            rand_range -= extra
        sizes[i] = MIN_PARTICLES_PER_GALAXY + extra
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    core_radius = np.empty(galaxy_count, dtype=np.float64)
    min_dist = np.empty(galaxy_count, dtype=np.float64)
    max_dist = np.empty(galaxy_count, dtype=np.float64)
    for i in range(galaxy_count):
        r = rng.uniform(GC_MIN_R, GC_MAX_R)
        core_radius[i] = r
        min_dist[i] = r * MIN_PARTICLE_DIST_CR_F
        max_dist[i] = (r * MAX_PARTICLE_DIST_CR_F
                       + np.sqrt(float(sizes[i])) * MAX_PARTICLE_DIST_PC_F)
    core_mass = np.asarray(r_to_m(core_radius, GC_DENSITY))

    core_pos = np.zeros((galaxy_count, 2), dtype=np.float64)
    for i in range(1, galaxy_count):
        while True:
            parent = int(rng.integers(0, i))
            min_sep = MIN_GALAXY_SEPARATION * (max_dist[i] + max_dist[parent])
            max_sep = MAX_GALAXY_SEPARATION * (max_dist[i] + max_dist[parent])
            dist = np.sqrt(rng.uniform(min_sep * min_sep, max_sep * max_sep))
            angle = rng.uniform(0.0, two_pi)
            cand = core_pos[parent] + dist * np.array([np.cos(angle), np.sin(angle)])
            collision = False
            for j in range(i):
                if j == parent:
                    continue
                other = MIN_GALAXY_SEPARATION * (max_dist[i] + max_dist[j])
                if np.sum((cand - core_pos[j]) ** 2) < other * other:
                    collision = True
                    break
            if not collision:
                core_pos[i] = cand
                break

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

    pos = np.zeros((particle_count, 2), dtype=np.float64)
    vel = np.zeros((particle_count, 2), dtype=np.float64)
    mass = np.zeros(particle_count, dtype=np.float64)
    radius = np.zeros(particle_count, dtype=np.float64)
    for i in range(galaxy_count):
        o, sz = int(offsets[i]), int(sizes[i])
        pos[o] = core_pos[i]
        vel[o] = core_vel[i]
        mass[o] = core_mass[i]
        radius[o] = core_radius[i]
        m = sz - 1
        if m == 0:
            continue
        initial_offset = rng.uniform(0.0, two_pi)
        spiral_count = int(rng.integers(MIN_SPIRALS, MAX_SPIRALS + 1))
        spiral_angle_dist = two_pi / spiral_count
        spiral_offsets = initial_offset + np.arange(spiral_count) * spiral_angle_dist
        t1 = two_pi
        b = max_dist[i] / t1
        t0 = min_dist[i] / b
        t = rng.uniform(t0, t1, size=m)
        r = b * t
        t_off = rng.uniform(0.0, 0.6 * np.sqrt(spiral_angle_dist), size=m)
        r_off = rng.uniform(
            0.0, 0.6 * np.sqrt(np.maximum(np.minimum(b, r - min_dist[i]), 0.0)),
            size=m)
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
        dist_range = max_dist[i] - min_dist[i]
        massless = rng.uniform(0.0, 1.0, size=m) < (dist - min_dist[i]) / dist_range
        body_r = rng.uniform(NP_MIN_R, NP_MAX_R, size=m)
        radius[p] = np.where(massless, TRACER_RADIUS, body_r)
        mass[p] = np.where(massless, 0.0, r_to_m(body_r, NP_DENSITY))
        speed = np.sqrt(G * core_mass[i] / dist)
        vel[p, 0] = core_vel[i, 0] + speed * (dy / dist)
        vel[p, 1] = core_vel[i, 1] + speed * (-dx / dist)

    return {"pos": pos.astype(np.float32), "vel": vel.astype(np.float32),
            "mass": mass.astype(np.float32),
            "radius": radius.astype(np.float32)}
