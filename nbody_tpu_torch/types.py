"""Core particle state types and constants, on PyTorch tensors.

Counterpart of ``nbody_tpu/types.py``. State is a structure of arrays of
float32 tensors with the same field names and layouts as the JAX package:
``pos``, ``vel`` and ``acc`` are (N, 2); ``mass`` and ``radius`` are (N,).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .integrators import INTEGRATORS

# Gravitational constant; `g = G * mass / dist^2` (reference include/nbody.h:8).
G = 10.0

# Default dtype of all physical state (the reference is fp32 throughout).
DTYPE = torch.float32

# Additive floor folded into the target radius wherever the softened
# r2 = dist_sq + radius is formed. Absorbed bitwise in fp32 for any real
# radius (>= 0.5); it turns the 0/0 of a zero-gm source coincident with a
# radius-0 target into an exact 0 (see nbody_tpu/types.py for the bound).
SOFTENING_FLOOR = 1e-18


@dataclass
class Particles:
    """Structure-of-arrays particle state: fp32 tensors on one device."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    mass: torch.Tensor
    radius: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def __len__(self) -> int:
        return self.n

    def slice_to(self, n: int) -> "Particles":
        return Particles(
            pos=self.pos[:n],
            vel=self.vel[:n],
            acc=self.acc[:n],
            mass=self.mass[:n],
            radius=self.radius[:n],
        )

    def to(self, device: torch.device | str) -> "Particles":
        return Particles(*(x.to(device) for x in astuple_shallow(self)))


def astuple_shallow(p: Particles) -> tuple:
    return (p.pos, p.vel, p.acc, p.mass, p.radius)


def make_particles(
    pos: Any, vel: Any = None, mass: Any = None, radius: Any = None, acc: Any = None
) -> Particles:
    """Build Particles from array-likes, filling defaults (vel/acc 0, mass 0,
    radius 1). Tensors keep their device; numpy input lands on the CPU."""
    pos = torch.as_tensor(pos, dtype=DTYPE)
    n = pos.shape[0]
    if tuple(pos.shape) != (n, 2):
        raise ValueError(f"pos must have shape (N, 2), got {tuple(pos.shape)}")

    def _arr(x, shape, default):
        if x is None:
            return torch.full(shape, default, dtype=DTYPE, device=pos.device)
        x = torch.as_tensor(x, dtype=DTYPE, device=pos.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
        return x

    return Particles(
        pos=pos,
        vel=_arr(vel, (n, 2), 0.0),
        acc=_arr(acc, (n, 2), 0.0),
        mass=_arr(mass, (n,), 0.0),
        radius=_arr(radius, (n,), 1.0),
    )


def zeros_particles(n: int, device: torch.device | str = "cpu") -> Particles:
    """n inert rows: zero pos, vel, acc and mass, radius 1."""
    def z(*shape):
        return torch.zeros(shape, dtype=DTYPE, device=device)

    return Particles(pos=z(n, 2), vel=z(n, 2), acc=z(n, 2), mass=z(n),
                     radius=torch.ones(n, dtype=DTYPE, device=device))


def concat_particles(a: Particles, b: Particles) -> Particles:
    """The rows of ``a`` followed by those of ``b``, field by field."""
    return Particles(*(torch.cat([x, y]) for x, y in
                       zip(astuple_shallow(a), astuple_shallow(b))))


@dataclass(frozen=True)
class SimConfig:
    """Simulation configuration: the fields of ``nbody_tpu.types.SimConfig``
    that the port's direct-sum, pm, p3m and sharded paths read, with the
    same defaults and the same ``ValueError``s.

    ``precise=True`` uses exact sqrt and divide (the reference shader,
    particle_cs.glsl:42-48); False uses rsqrt cubed. ``integrator`` is
    "euler" (the reference's semi-implicit Euler), "leapfrog" or "yoshida4"
    (see integrators.py).

    Mesh backends (``ops/pm_forces.py``, ``ops/p3m_forces.py``):
    ``pm_grid`` is the mesh resolution and ``pm_softening`` the global
    Plummer length of the mesh kernel. P³M tapers the mesh kernel at
    rc = ``p3m_rc_cells`` grid cells, corrects pairs closer than rc from
    cells holding up to ``p3m_cell_capacity`` heaviest sources (and as many
    targets), and gives the ``p3m_exact_targets`` largest-radius targets a
    direct-sum row. ``p3m_rebin_interval`` rebuilds the cell sorts every
    that many substeps (1 = every substep).

    ``p3m_pp_chunk`` and ``p3m_pp_compact`` are accepted, validated as in
    ``nbody_tpu``, and change nothing: there they pick bit-identical
    schedules of a sequential TPU map (chunk skipping, active-cell
    compaction); here the pair-correction kernel skips empty cells itself.

    ``tile_targets`` and ``tile_sources`` set the padded layout of a
    sharded world (``parallel/sharding.shard_layout``): per-shard target
    and source counts round up to them once they exceed them. The port's
    kernels choose their own block sizes.

    ``merge_collisions`` merges overlapping massive bodies
    (|d| < ``merge_factor`` · (r_i + r_j)) lighter into heavier after
    every substep, with exact mass and momentum transfer; the absorbed row
    becomes a massless tracer (``ops/collisions.py``).
    """

    g: float = G
    precise: bool = False
    integrator: str = "euler"
    pm_grid: int = 512
    pm_softening: float = 2.0
    p3m_rc_cells: int = 4
    p3m_cell_capacity: int = 96
    p3m_exact_targets: int = 64
    p3m_rebin_interval: int = 1
    p3m_pp_chunk: int = 64
    p3m_pp_compact: int = 0
    tile_targets: int = 512
    tile_sources: int = 2048
    merge_collisions: bool = False
    merge_factor: float = 1.0

    def __post_init__(self):
        if self.merge_factor <= 0:
            raise ValueError(
                f"merge_factor must be > 0, got {self.merge_factor}")
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                "integrator must be 'euler', 'leapfrog', or 'yoshida4', "
                f"got {self.integrator!r}"
            )
        if self.pm_grid < 64:
            raise ValueError(f"pm_grid must be >= 64, got {self.pm_grid}")
        if self.pm_softening <= 0:
            raise ValueError(
                f"pm_softening must be > 0, got {self.pm_softening}")
        if self.p3m_rc_cells < 2:
            raise ValueError(
                f"p3m_rc_cells must be >= 2, got {self.p3m_rc_cells}")
        if self.p3m_cell_capacity < 8:
            raise ValueError(
                f"p3m_cell_capacity must be >= 8, got {self.p3m_cell_capacity}")
        if self.p3m_exact_targets < 0:
            raise ValueError(
                f"p3m_exact_targets must be >= 0, got {self.p3m_exact_targets}")
        if self.p3m_rebin_interval < 1:
            raise ValueError(
                f"p3m_rebin_interval must be >= 1, got "
                f"{self.p3m_rebin_interval}")
        if self.p3m_pp_chunk < 0:
            raise ValueError(
                f"p3m_pp_chunk must be >= 0 (0 = off), got "
                f"{self.p3m_pp_chunk}")
        if self.p3m_pp_compact < 0:
            raise ValueError(
                f"p3m_pp_compact must be >= 0 (0 = off), got "
                f"{self.p3m_pp_compact}")
        if self.p3m_pp_compact:
            if not self.p3m_pp_chunk:
                raise ValueError(
                    "p3m_pp_compact requires p3m_pp_chunk > 0 (the "
                    "compacted panel is iterated in pp_chunk-cell pieces)")
            if self.p3m_pp_compact % self.p3m_pp_chunk:
                raise ValueError(
                    f"p3m_pp_compact ({self.p3m_pp_compact}) must be a "
                    f"multiple of p3m_pp_chunk ({self.p3m_pp_chunk})")
        if (self.tile_targets < 8 or self.tile_sources < 128
                or self.tile_targets % 8 or self.tile_sources % 128):
            raise ValueError(
                f"tile_targets must be a multiple of 8 and tile_sources a "
                f"multiple of 128, got {self.tile_targets}x{self.tile_sources}")


# Galaxy generation constants, mirroring include/galaxy.h:10-61.
@dataclass(frozen=True)
class GalaxyConfig:
    pi: float = 3.1415927
    min_spirals: int = 2
    max_spirals: int = 4
    gc_min_r: float = 200.0
    gc_max_r: float = 600.0
    gc_density: float = 30.0
    np_min_r: float = 1.5
    np_max_r: float = 9.5
    np_density: float = 10.0
    min_particles_per_galaxy: int = 100
    min_particle_dist_cr_f: float = 5.0
    max_particle_dist_cr_f: float = 10.0
    max_particle_dist_pc_f: float = 300.0
    min_galaxy_separation: float = 1.4
    max_galaxy_separation: float = 2.0
    # Massless tracer parameters (galaxy.c:205-206).
    tracer_radius: float = 0.5

    def r_to_m(self, r, density) -> Any:
        """Mass from radius: m = (4*pi*rho/3) * r^3 (galaxy.h:21-24)."""
        return (4.0 * self.pi * density / 3.0) * r * r * r

    @property
    def min_gc_mass(self) -> float:
        return float(self.r_to_m(self.gc_min_r, self.gc_density))


DEFAULT_GALAXY_CONFIG = GalaxyConfig()
DEFAULT_SIM_CONFIG = SimConfig()


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
