"""World: particle state on one device, the backend switch and the substep
loop. Counterpart of ``nbody_tpu/world.py`` for the direct-sum, pm and p3m
paths.

  * Creation partitions particles massive-first with a stable sort
    (world.c:33-46; the same order as ``nbody_tpu``), moves them to the
    device ("cuda" unless the caller names another), and forms
    ``gm = g * mass[:mass_len]``.
    State has exactly N rows: the CUDA kernel masks its own ragged edges,
    so no target or source padding is needed.
  * ``update(dt, n)`` is a Python loop of n substeps. On the "cuda" backend
    each substep (each DKD stage for leapfrog/yoshida4) is one launch of
    the fused force-and-integrate kernel; "torch" is the plain PyTorch
    version. "pm" and "p3m" are the mesh solvers (``ops/pm_forces.py``,
    ``ops/p3m_forces.py``) with the integrator's stage loop around them;
    p3m's pair correction and exact-core rows run through the CUDA kernels
    on a CUDA world and their plain versions on a CPU one. The loop never
    syncs with the host: ``dt`` stays a Python float, and only
    ``particles`` and ``block_until_ready`` wait.
  * Jacobi substeps: every launch reads (pos, vel) and writes new buffers,
    and the World swaps them in, as the reference double-buffers its
    storage (sim_gpu.c:19). PyTorch's caching allocator hands the freed
    pair back to the next launch.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch.profiler import record_function

from . import forces, integrators
from .ops.direct_forces import fused_substep
from .ops.p3m_forces import exact_core_rows, p3m_acc_from_bins, p3m_bins
from .ops.pm_forces import pm_acc
from .types import (DEFAULT_SIM_CONFIG, DTYPE, Particles, SimConfig,
                    astuple_shallow)

Backend = Literal["torch", "cuda", "pm", "p3m", "auto"]
BACKENDS = ("torch", "cuda", "pm", "p3m")

# "auto" picks the direct sum at or below this many pair evaluations per
# substep (total_len * mass_len) and p3m above. This is nbody_tpu's rule
# and number (nbody_tpu/world.py:81-100), set on a TPU; the H100's own
# crossover is a measurement still to make (ROADMAP A6).
AUTO_P3M_MIN_PAIRS = 16_000_000_000


def resolve_backend(backend: Backend, total_len: int, mass_len: int, *,
                    direct: Backend = "torch") -> Backend:
    """Resolve ``"auto"`` by nbody_tpu's rule: ``direct`` (the device's
    direct-sum backend, where nbody_tpu answers "jnp") at or below
    AUTO_P3M_MIN_PAIRS, "p3m" above. The port has no collision merging, so
    the rule's merging branch ("pm") never applies. Every other backend
    passes through unchanged."""
    if backend != "auto":
        return backend
    return direct if total_len * mass_len <= AUTO_P3M_MIN_PAIRS else "p3m"


def partition_massive_first(mass) -> tuple[torch.Tensor, int]:
    """Return (permutation, mass_len): indices reordering particles so all
    with mass > 0 come first (world.c:33-46). Stable within each group."""
    mass = torch.as_tensor(mass)
    order = torch.argsort((mass <= 0).to(torch.int8), stable=True)
    mass_len = int(torch.count_nonzero(mass > 0))
    return order, mass_len


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device}")
    return device


class World:
    """Stateful wrapper mirroring the reference World ergonomics
    (nbody.h:61-73): create, update, read back."""

    def __init__(self, particles: Particles, *, config: SimConfig = DEFAULT_SIM_CONFIG,
                 default_backend: Backend | None = None,
                 device: torch.device | str = "cuda"):
        self.device = _resolve_device(device)
        order, mass_len = partition_massive_first(particles.mass)

        def put(x):
            x = torch.as_tensor(x, dtype=DTYPE)
            return x[order.to(x.device)].to(self.device).contiguous()

        self.state = Particles(
            pos=put(particles.pos), vel=put(particles.vel),
            acc=put(particles.acc), mass=put(particles.mass),
            radius=put(particles.radius))
        self.gm = (config.g * self.state.mass[:mass_len]).contiguous()
        # The mesh solvers take max(mass_len, 1) sources (a world with no
        # mass gets one inert gm = 0 source), as nbody_tpu's
        # effective_src_len does.
        self._mesh_gm = (self.gm if mass_len else
                         torch.zeros(1, dtype=DTYPE, device=self.device))
        self._softening = torch.tensor(config.pm_softening, dtype=DTYPE,
                                       device=self.device)
        self.total_len = self.state.n
        self.mass_len = mass_len
        self.config = config
        # None is the device's direct backend, as nbody_tpu's None is
        # "pallas" or "jnp"
        self._direct: Backend = "cuda" if self.device.type == "cuda" else "torch"
        self.default_backend: Backend = self._resolve(default_backend)
        self._host_cache: Particles | None = None

    # -- update ---------------------------------------------------------
    def _resolve(self, backend: Backend | None) -> Backend:
        backend = resolve_backend(backend or self._direct, self.total_len,
                                  self.mass_len, direct=self._direct)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or 'auto', "
                             f"got {backend!r}")
        return backend

    def update(self, dt: float, n: int = 1, backend: Backend | None = None) -> "World":
        """n substeps of size dt on ``backend`` (default: the world's
        ``default_backend``; "auto" resolves as :func:`resolve_backend`
        says). "p3m" builds its cell bins at the first substep of the call
        and again at every substep index that is a multiple of
        ``p3m_rebin_interval``, as ``nbody_tpu`` does."""
        backend = self._resolve(backend or self.default_backend)
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' needs a world on a CUDA device, this one is "
                f"on {self.device}")
        if n <= 0:
            return self
        dt = float(dt)
        if backend == "p3m":
            self._update_p3m(dt, n)
        else:
            step = {"cuda": self._step_cuda, "torch": self._step_torch,
                    "pm": self._step_pm}[backend]
            for _ in range(n):
                step(dt)
        self._host_cache = None
        return self

    def _advance(self, force_at, dt: float) -> None:
        st = self.state
        pos, vel, acc = integrators.advance(
            self.config.integrator, force_at, st.pos, st.vel, dt)
        self.state = Particles(pos=pos, vel=vel, acc=acc, mass=st.mass,
                               radius=st.radius)

    def _step_pm(self, dt: float) -> None:
        s = self._mesh_gm.shape[0]

        def force_at(p):
            return pm_acc(p, p[:s], self._mesh_gm, self._softening,
                          grid=self.config.pm_grid)

        self._advance(force_at, dt)

    def _update_p3m(self, dt: float, n: int) -> None:
        cfg = self.config
        radius = self.state.radius
        s = self._mesh_gm.shape[0]
        # radius is constant: the exact-core rows are chosen once per call
        big = exact_core_rows(radius, cfg.p3m_exact_targets)

        def bins_of(pos):
            with record_function("p3m.bins"):
                return p3m_bins(pos, radius, pos[:s], self._mesh_gm,
                                grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                                exact_targets=cfg.p3m_exact_targets, big=big)

        bins = bins_of(self.state.pos)
        for i in range(n):
            if i > 0 and i % cfg.p3m_rebin_interval == 0:
                bins = bins_of(self.state.pos)

            # every stage of a substep shares the substep's bins
            def force_at(p, bins=bins):
                return p3m_acc_from_bins(
                    bins, p, radius, p[:s], self._mesh_gm, self._softening,
                    grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                    cell_capacity=cfg.p3m_cell_capacity, precise=cfg.precise)

            self._advance(force_at, dt)

    def _step_cuda(self, dt: float) -> None:
        st = self.state
        ws = integrators.stage_weights(self.config.integrator)
        pos, vel, acc = st.pos, st.vel, st.acc
        for w in (1.0,) if ws is None else ws:
            dtk = integrators.stage_dt(w, dt)
            pos_in = pos if ws is None else pos + (0.5 * dtk) * vel
            pos, vel, acc = fused_substep(
                dtk, pos_in, vel, st.radius, self.gm,
                precise=self.config.precise,
                pos_dt=1.0 if ws is None else 0.5)
        self.state = Particles(pos=pos, vel=vel, acc=acc, mass=st.mass,
                               radius=st.radius)

    def _step_torch(self, dt: float) -> None:
        radius = self.state.radius

        def force_at(p):
            return forces.direct_sum_acc(p, radius, p[:self.mass_len],
                                         self.gm, precise=self.config.precise)

        self._advance(force_at, dt)

    # Reference API names (nbody.h:69-73): "CPU" = the plain PyTorch
    # version, "GPU" = the CUDA kernel.
    def update_cpu(self, dt: float, n: int = 1) -> "World":
        return self.update(dt, n, backend="torch")

    def update_gpu(self, dt: float, n: int = 1) -> "World":
        return self.update(dt, n, backend="cuda")

    # -- read back -------------------------------------------------------
    @property
    def particles(self) -> Particles:
        """Freshest state as CPU tensors, in partitioned order
        (GetWorldParticles, world.c:91-97). Cached until the next update."""
        if self._host_cache is None:
            self._host_cache = Particles(
                *(x.to("cpu", copy=True) for x in astuple_shallow(self.state)))
        return self._host_cache

    def block_until_ready(self) -> "World":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def __len__(self) -> int:
        return self.total_len


def create_world(particles: Particles, *, config: SimConfig = DEFAULT_SIM_CONFIG,
                 default_backend: Backend | None = None,
                 device: torch.device | str = "cuda") -> World:
    """CreateWorld (nbody.h:61) on ``device`` ("cuda[:k]", the default, or
    "cpu"). Without a GPU, "cuda" raises. ``default_backend`` as in
    nbody_tpu: None is the device's direct backend ("cuda" or "torch"),
    "auto" resolves by :func:`resolve_backend`."""
    return World(particles, config=config, default_backend=default_backend,
                 device=device)
