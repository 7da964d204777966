"""Seconds the program spent loading its CUDA libraries
(``nbody_tpu_torch.ops._build.LOADED``: the hash of the sources, ``nvcc
--version``, a build on a miss, and dlopen). Each library loads once a
process, in the set-up: the warm-up call runs every kernel that the
windows run, and the judge runs none."""

import sys


def read(ctx):
    build = sys.modules.get("nbody_tpu_torch.ops._build")
    loaded = getattr(build, "LOADED", None)
    return sum(loaded.values()) if loaded else None
