"""nbody-tpu's PyTorch / CUDA port: 2D direct-sum gravity on an NVIDIA GPU.

The same public names as ``nbody_tpu`` for the ported subset: scene
generation (numpy), world creation on an explicit device, substeps of exact
direct-sum gravity through a hand-written CUDA kernel ("cuda" backend) or
plain PyTorch ("torch" backend), and readback. Imports neither JAX nor
``nbody_tpu``.
"""

from .types import (
    G,
    DTYPE,
    GalaxyConfig,
    Particles,
    SimConfig,
    DEFAULT_GALAXY_CONFIG,
    DEFAULT_SIM_CONFIG,
    make_particles,
)
from .forces import direct_sum_acc, pair_acc
from .galaxy import make_galaxies
from .world import World, create_world, partition_massive_first

__version__ = "0.1.0"

__all__ = [
    "G",
    "DTYPE",
    "GalaxyConfig",
    "Particles",
    "SimConfig",
    "DEFAULT_GALAXY_CONFIG",
    "DEFAULT_SIM_CONFIG",
    "make_particles",
    "direct_sum_acc",
    "pair_acc",
    "make_galaxies",
    "World",
    "create_world",
    "partition_massive_first",
    "__version__",
]
