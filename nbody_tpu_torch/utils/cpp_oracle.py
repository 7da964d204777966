"""ctypes loader for the native C++ AVX parity oracle (``cpp/nbody_oracle.cpp``).

Counterpart of ``nbody_tpu/utils/cpp_oracle.py``. The oracle is an
independent host implementation of the reference's CPU backend
(``sim_cpu.c``: 8-wide AVX sums, no FMA contraction, IEEE sqrt,
semi-implicit Euler), a judge of the port's kernels that shares no code
with them. Its library is built on first use from ``cpp/`` into
``build/cpp/`` (``utils/_native.py``; g++, a few seconds; on one
thread where the compiler has no OpenMP runtime).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..types import Particles, make_particles
from . import _native

_lib = None


class OracleUnavailable(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_native.build("nbody_oracle")))
    except (_native.NativeBuildError, OSError) as e:
        raise OracleUnavailable(f"cpp oracle unavailable: {e}") from e
    f32p = ctypes.POINTER(ctypes.c_float)
    for name in ("nb_oracle_update", "nb_oracle_update_scalar"):
        fn = getattr(lib, name)
        fn.argtypes = [f32p, f32p, f32p, f32p, f32p,
                       ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_uint32]
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OracleUnavailable:
        return False


def _host(x) -> np.ndarray:
    """A contiguous float32 copy on the host of a tensor on any device."""
    x = torch.as_tensor(x).detach().to("cpu", torch.float32)
    return np.array(x.numpy(), dtype=np.float32, order="C")


def oracle_update(
    particles: Particles,
    mass_len: int,
    dt: float,
    n_steps: int,
    *,
    scalar: bool = False,
) -> Particles:
    """Run n_steps substeps with the native oracle (the 8-wide AVX build,
    or its scalar loop with ``scalar``). The input must be in massive-first
    order (rows [0, mass_len) are the sources), on any device; it is copied
    to the host and not modified. Returns new Particles on the CPU."""
    lib = _load()
    pos, vel, acc, mass, radius = (_host(getattr(particles, f)) for f in
                                   ("pos", "vel", "acc", "mass", "radius"))
    f32p = ctypes.POINTER(ctypes.c_float)
    fn = lib.nb_oracle_update_scalar if scalar else lib.nb_oracle_update
    fn(pos.ctypes.data_as(f32p), vel.ctypes.data_as(f32p),
       acc.ctypes.data_as(f32p), mass.ctypes.data_as(f32p),
       radius.ctypes.data_as(f32p), ctypes.c_uint32(pos.shape[0]),
       ctypes.c_uint32(mass_len), ctypes.c_float(dt),
       ctypes.c_uint32(n_steps))
    return make_particles(pos, vel=vel, acc=acc, mass=mass, radius=radius)
