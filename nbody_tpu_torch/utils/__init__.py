from .checkpoint import (
    load_particles,
    load_world,
    save_particles,
    save_world,
    save_world_atomic,
)
from .libc_rand import LibcRand
from .profiling import StepTimer, annotate, trace

__all__ = ["LibcRand", "load_particles", "load_world", "save_particles",
           "save_world", "save_world_atomic", "StepTimer", "annotate", "trace"]
