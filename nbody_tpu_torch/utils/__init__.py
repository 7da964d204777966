from .checkpoint import (
    load_particles,
    load_world,
    save_particles,
    save_world,
    save_world_atomic,
)
from .compile_cache import cache_entries, default_cache_dir, enable_compile_cache
from .libc_rand import LibcRand
from .profiling import StepTimer, annotate, trace

__all__ = ["LibcRand", "load_particles", "load_world", "save_particles",
           "save_world", "save_world_atomic", "enable_compile_cache",
           "default_cache_dir", "cache_entries", "StepTimer", "annotate",
           "trace"]
