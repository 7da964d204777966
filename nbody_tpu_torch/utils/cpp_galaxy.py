"""ctypes loader for the native C++ scene generator (``cpp/galaxy_gen.cpp``).

Counterpart of ``nbody_tpu/utils/cpp_galaxy.py``: a second, host-native
implementation of the spiral-galaxy algorithm (reference ``galaxy.c``),
an alternative scene source and a structural cross-check of the Python
generators. Its library is built on first use from ``cpp/`` into
``build/cpp/`` (``utils/_native.py``), so the port's scenes are the very
bits of ``nbody_tpu``'s for the same seed.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..types import Particles, make_particles
from . import _native

_lib = None


class GeneratorUnavailable(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_native.build("nbody_galaxy")))
    except (_native.NativeBuildError, OSError) as e:
        raise GeneratorUnavailable(f"cpp generator unavailable: {e}") from e
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.nb_make_galaxies.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        f32p, f32p, f32p, f32p,
    ]
    lib.nb_make_galaxies.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except GeneratorUnavailable:
        return False


def make_galaxies_native(
    particle_count: int, galaxy_count: int, *, seed: int = 0
) -> Particles:
    """Generate a scene with the native C++ generator (its own RNG stream;
    deterministic per seed; the same distributions as the Python
    generators). Returns Particles on the CPU."""
    lib = _load()
    n = particle_count
    pos = np.empty((n, 2), np.float32)
    vel = np.empty((n, 2), np.float32)
    mass = np.empty(n, np.float32)
    radius = np.empty(n, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.nb_make_galaxies(
        ctypes.c_uint64(seed), ctypes.c_uint32(n), ctypes.c_uint32(galaxy_count),
        pos.ctypes.data_as(f32p), vel.ctypes.data_as(f32p),
        mass.ctypes.data_as(f32p), radius.ctypes.data_as(f32p),
    )
    if rc == 2:
        raise ValueError("galaxy_count must be >= 1")
    if rc != 0:
        raise ValueError(
            f"need at least {galaxy_count * 100} particles for "
            f"{galaxy_count} galaxies, got {particle_count}"
        )
    return make_particles(pos, vel=vel, mass=mass, radius=radius)
