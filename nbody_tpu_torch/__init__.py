"""nbody-tpu's PyTorch / CUDA port: 2D gravity on an NVIDIA GPU.

The same public names as ``nbody_tpu`` for the ported subset: scene
generation (numpy on the host; spiral galaxies, Plummer, Kepler and cold
disks drawn on the device in ``nbody_tpu_torch.models``), world creation
(on the GPU unless the caller asks for the CPU), substeps of exact
direct-sum gravity through a hand-written CUDA kernel ("cuda" backend) or
plain PyTorch ("torch" backend), the particle-mesh ("pm") and P³M ("p3m")
solvers, user force hooks, adaptive dt, collision merging
(``SimConfig.merge_collisions``), and readback; in
``nbody_tpu_torch.diagnostics``, energy, momentum and the dt criterion; in
``nbody_tpu_torch.parallel``, the world sharded over a list of devices with
the ring of source tiles or the collective mesh solvers, in one process or
over the processes of a ``torch.distributed`` group (``multihost``);
trajectory capture (``trajectory``), rendering (``render``,
``viewer.export_animation``), the interactive viewers (``viewer``,
``viewer_sdl``), npz checkpoints, debug checks, profiling helpers and the
native C++ oracles (``utils``), differentiable rollouts (``autodiff``),
and the command line, ``python -m nbody_tpu_torch run|render|gif|view``.
Imports neither JAX nor ``nbody_tpu``.
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
    zeros_particles,
    concat_particles,
)
from .forces import acc_from_particles, direct_sum_acc, pair_acc
from .galaxy import make_galaxies
from .models.galaxy_device import make_galaxies_device
from .ops.p3m_forces import p3m_acc, p3m_cell_overflow
from .ops.pm_forces import pm_acc, suggest_grid
from .world import (World, create_world, partition_massive_first,
                    resolve_backend, update_state)

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
    "zeros_particles",
    "concat_particles",
    "acc_from_particles",
    "direct_sum_acc",
    "pair_acc",
    "make_galaxies",
    "make_galaxies_device",
    "pm_acc",
    "p3m_acc",
    "p3m_cell_overflow",
    "suggest_grid",
    "World",
    "create_world",
    "partition_massive_first",
    "resolve_backend",
    "update_state",
    "__version__",
]
