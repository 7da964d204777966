"""Bit-exact reference scenes: ``MakeGalaxies`` reproduced to the last bit.

A copy of ``nbody_tpu/models/galaxy_ref.py`` for the PyTorch port; only the
returned container holds CPU tensors. The original's description follows.

``make_galaxies_libc(n, g, seed)`` yields the *exact* float32 particle array
the C reference produces for ``srand(seed); MakeGalaxies(n, g)``
(``src/lib/galaxy.c:31-221``) — same rand() stream (glibc clone,
``utils/libc_rand.py``), same float32 operation order, same libm
transcendentals (``cosf``/``sinf``/``hypotf`` called through ctypes so the
very same code paths round the same way). This closes the PARITY.md
deviation "bit-exact reference scenes are impossible portably": they are
portable after all, because glibc's rand() is a fixed documented algorithm.

This is a *parity oracle*, not the production generator: it walks the
particles in Python scalar-by-scalar because bit-exactness pins the
evaluation order (≈1 s per 20k particles). Production scenes come from
``galaxy.make_galaxies`` (vectorized numpy).

Semantics mirrored (with galaxy.c / galaxy.h line cites inline):
  * galaxy sizing draws, core radius/mass, rejection-sampled placement,
    inter-core velocity kicks, spiral-arm particle draws — in the exact
    rand()-consumption order (including the zero-range ``rand() % 1``
    draws that only advance the stream);
  * all arithmetic in C float (numpy float32 scalars), RandFloat's double
    intermediate included (galaxy.c:18-20);
  * transcendentals via the platform libm so e.g. ``cosf`` rounds
    identically to the reference binary.

Validated end-to-end by tests/test_libc_scene.py, which compiles the
reference's own galaxy.c from its source tree in place and compares dumps
bitwise.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from ..types import Particles, make_particles
from ..utils.libc_rand import LibcRand

f32 = np.float32

# ---------------------------------------------------------------------------
# libm via ctypes: same rounding as the reference binary, not numpy's.
# ---------------------------------------------------------------------------

def _load_libm():
    for cand in ("libm.so.6", ctypes.util.find_library("m")):
        if not cand:
            continue
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    return None


_LIBM = _load_libm()

if _LIBM is not None:
    for _name, _nargs in (("cosf", 1), ("sinf", 1), ("sqrtf", 1),
                          ("hypotf", 2), ("fminf", 2)):
        _fn = getattr(_LIBM, _name)
        _fn.restype = ctypes.c_float
        _fn.argtypes = [ctypes.c_float] * _nargs

    def _cosf(x): return f32(_LIBM.cosf(float(x)))
    def _sinf(x): return f32(_LIBM.sinf(float(x)))
    def _sqrtf(x): return f32(_LIBM.sqrtf(float(x)))
    def _hypotf(x, y): return f32(_LIBM.hypotf(float(x), float(y)))
    def _fminf(x, y): return f32(_LIBM.fminf(float(x), float(y)))
else:  # pragma: no cover - non-glibc fallback (sqrt is IEEE-exact anyway)
    def _cosf(x): return f32(np.cos(f32(x)))
    def _sinf(x): return f32(np.sin(f32(x)))
    def _sqrtf(x): return f32(np.sqrt(f32(x)))
    def _hypotf(x, y): return f32(np.hypot(f32(x), f32(y)))
    def _fminf(x, y): return min(f32(x), f32(y))


def available() -> bool:
    """True when the real libm is loaded (bit-exactness guaranteed)."""
    return _LIBM is not None


# ---------------------------------------------------------------------------
# Constants (galaxy.h:10-61, nbody.h:8). Float32 exactly as the C macros
# evaluate them.
# ---------------------------------------------------------------------------

_PI = f32(3.1415927)            # galaxy.h:7 "homegrown constants are the best"
_TWO_PI = f32(2) * _PI
_NB_G = f32(10.0)               # nbody.h:8
_MIN_PER_GALAXY = 100           # galaxy.h:27
_GC_MIN_R, _GC_MAX_R = f32(200.0), f32(600.0)
_NP_MIN_R, _NP_MAX_R = f32(1.5), f32(9.5)
_MIN_SPIRALS, _MAX_SPIRALS = 2, 4
_MIN_DIST_CR_F = f32(5.0)       # galaxy.h:44-46
_MAX_DIST_CR_F = f32(10.0)
_MAX_DIST_PC_F = f32(300.0)
_MIN_SEP = f32(1.4)             # galaxy.h:60-61
_MAX_SEP = f32(2.0)
_RAND_MAX = 2147483647.0


def _r_to_m(r: np.float32, density: float) -> np.float32:
    """R_TO_M (galaxy.h:20): ``(4.f * PI * D / 3.f) * R * R * R`` in f32."""
    factor = f32(4) * _PI * f32(density) / f32(3)
    return factor * r * r * r


class _Rng:
    """galaxy.c:17-29 helpers over the glibc clone."""

    def __init__(self, seed: int):
        self._rand = LibcRand(seed).rand

    def flt(self, lo, hi) -> np.float32:
        # (float)(min + (max - min) * rand() / RAND_MAX): double intermediate
        lo, hi = float(lo), float(hi)
        return f32(lo + (hi - lo) * self._rand() / _RAND_MAX)

    def uint(self, lo: int, hi: int) -> int:
        # note hi == lo + 1 still consumes a draw (rand() % 1)
        return lo + self._rand() % (hi - lo)

    def bool(self) -> bool:
        return bool(self._rand() & 1)


def make_galaxies_libc(
    particle_count: int,
    galaxy_count: int,
    *,
    seed: int = 11037,
) -> Particles:
    """The reference's exact scene for ``srand(seed); MakeGalaxies(n, g)``.

    Returns particles in the reference's generation order (galaxy cores at
    each galaxy's first slot), bit-identical float32 pos/vel/mass/radius.
    Default seed is the reference bench's 11037 (bench.c:42).
    """
    if particle_count < galaxy_count * _MIN_PER_GALAXY:
        raise ValueError(
            f"need at least {galaxy_count * _MIN_PER_GALAXY} particles for "
            f"{galaxy_count} galaxies, got {particle_count}")  # galaxy.c:32-34
    rng = _Rng(seed)

    # -- galaxy sizes (galaxy.c:46-66): sequential draws shrink the pool
    rand_range = particle_count - galaxy_count * _MIN_PER_GALAXY
    sizes = []
    for i in range(galaxy_count):
        if i == galaxy_count - 1:
            extra = rand_range
        else:
            extra = rng.uint(0, 1 + rand_range)
            rand_range -= extra
        sizes.append(_MIN_PER_GALAXY + extra)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(int)

    # -- core radius/mass and per-galaxy distance envelope (galaxy.c:69-81)
    core_radius, core_mass, min_dist, max_dist = [], [], [], []
    for size in sizes:
        r = rng.flt(_GC_MIN_R, _GC_MAX_R)
        size_root = _sqrtf(f32(size))
        core_radius.append(r)
        core_mass.append(_r_to_m(r, 30.0))  # GC_DENSITY
        min_dist.append(r * _MIN_DIST_CR_F)
        max_dist.append(r * _MAX_DIST_CR_F + size_root * _MAX_DIST_PC_F)

    # -- rejection-sampled core placement (galaxy.c:84-119)
    core_pos = [(f32(0), f32(0))] + [None] * (galaxy_count - 1)
    for i in range(1, galaxy_count):
        while True:
            parent = rng.uint(0, i)
            pair = max_dist[i] + max_dist[parent]
            min_sep = _MIN_SEP * pair
            max_sep = _MAX_SEP * pair
            dist = _sqrtf(rng.flt(min_sep * min_sep, max_sep * max_sep))
            angle = rng.flt(0, _TWO_PI)
            px = core_pos[parent][0] + dist * _cosf(angle)
            py = core_pos[parent][1] + dist * _sinf(angle)
            collision = False
            for j in range(i):
                if j == parent:
                    continue
                o_min_sep = _MIN_SEP * (max_dist[i] + max_dist[j])
                dx, dy = px - core_pos[j][0], py - core_pos[j][1]
                if dx * dx + dy * dy < o_min_sep * o_min_sep:
                    collision = True
                    break
            if not collision:
                core_pos[i] = (px, py)
                break

    # -- pairwise tangential velocity kicks (galaxy.c:122-144); note kicks
    #    accumulate on BOTH cores, earlier galaxies included
    core_vel = [[f32(0), f32(0)] for _ in range(galaxy_count)]
    for i in range(1, galaxy_count):
        for j in range(i):
            abx = core_pos[j][0] - core_pos[i][0]
            aby = core_pos[j][1] - core_pos[i][1]
            dist = _hypotf(abx, aby)  # MagV2, nbody.h:37-39
            inv = f32(1.0) / dist
            ux, uy = abx * inv, aby * inv
            speed_a = f32(0.3) * _sqrtf(_NB_G * core_mass[j] / dist)
            speed_b = f32(0.3) * _sqrtf(_NB_G * core_mass[i] / dist)
            core_vel[i][0] = core_vel[i][0] + uy * speed_a
            core_vel[i][1] = core_vel[i][1] + (-ux) * speed_a
            core_vel[j][0] = core_vel[j][0] + (-uy) * speed_b
            core_vel[j][1] = core_vel[j][1] + ux * speed_b

    # -- spiral-arm particles (galaxy.c:147-219)
    pos = np.zeros((particle_count, 2), np.float32)
    vel = np.zeros((particle_count, 2), np.float32)
    mass = np.zeros(particle_count, np.float32)
    radius = np.zeros(particle_count, np.float32)
    for i in range(galaxy_count):
        off = int(offsets[i])
        cx, cy = core_pos[i]
        cvx, cvy = core_vel[i]
        cmass = core_mass[i]
        pos[off] = (cx, cy)
        vel[off] = (cvx, cvy)
        mass[off] = cmass
        radius[off] = core_radius[i]

        dist_range = max_dist[i] - min_dist[i]
        initial_offset = rng.flt(0, _TWO_PI)
        spiral_count = rng.uint(_MIN_SPIRALS, 1 + _MAX_SPIRALS)
        spiral_angle_dist = _TWO_PI / f32(spiral_count)
        spiral_offsets = [initial_offset + f32(j) * spiral_angle_dist
                          for j in range(spiral_count)]

        # r(t) = b*t Archimedean spiral pinned at (t0, min_dist), (2pi, max_dist)
        t1 = _TWO_PI
        b = max_dist[i] / t1
        t0 = min_dist[i] / b

        toff_hi = f32(0.6) * _sqrtf(spiral_angle_dist)
        for j in range(1, sizes[i]):
            t = rng.flt(t0, t1)
            r = b * t
            t_offset = rng.flt(0, toff_hi)
            r_offset = rng.flt(0, f32(0.6) * _sqrtf(_fminf(b, r - min_dist[i])))
            dist = r + (f32(-1.0) if rng.bool() else f32(1.0)) * (r_offset * r_offset)
            ang = t + (f32(-1.0) if rng.bool() else f32(1.0)) * (t_offset * t_offset)
            spiral_offset = spiral_offsets[rng.uint(0, spiral_count)]
            dx = dist * _cosf(ang + spiral_offset)
            dy = dist * _sinf(ang + spiral_offset)
            k = off + j
            pos[k] = (cx + dx, cy + dy)
            # farther out -> likelier massless tracer (galaxy.c:205-212)
            if rng.flt(0.0, 1.0) < (dist - min_dist[i]) / dist_range:
                radius[k], mass[k] = f32(0.5), f32(0.0)
            else:
                pr = rng.flt(_NP_MIN_R, _NP_MAX_R)
                radius[k], mass[k] = pr, _r_to_m(pr, 10.0)  # NP_DENSITY
            speed = _sqrtf(_NB_G * cmass / dist)
            vel[k] = (cvx + speed * (dy / dist), cvy + speed * (-dx / dist))

    return make_particles(pos, vel=vel, mass=mass, radius=radius)
