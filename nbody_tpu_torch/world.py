"""World: particle state on one device, the backend switch and the substep
loop. Counterpart of ``nbody_tpu/world.py`` for the direct-sum, pm and p3m
paths.

  * Creation partitions particles massive-first with a stable sort
    (world.c:33-46; the same order as ``nbody_tpu``), moves them to the
    device ("cuda" unless the caller names another), and forms
    ``gm = g * mass[:mass_len]``.
    State has exactly N rows: the CUDA kernel masks its own ragged edges,
    so no target or source padding is needed, and no ``valid`` mask.
  * ``update(dt, n)`` (:func:`update_state`) is a Python loop of n
    substeps. On the "cuda" backend each substep (each DKD stage for
    leapfrog/yoshida4) is one launch of the fused force-and-integrate
    kernel; "torch" is the plain PyTorch version. "pm" and "p3m" are the
    mesh solvers (``ops/pm_forces.py``, ``ops/p3m_forces.py``) with the
    integrator's stage loop around them; p3m's pair correction and
    exact-core rows run through the CUDA kernels on a CUDA world and their
    plain versions on a CPU one. The loop never syncs with the host:
    ``dt`` stays a Python float, and only ``particles`` and
    ``block_until_ready`` wait.
  * ``extra_force(pos, vel) -> acc`` adds a user acceleration field to
    self-gravity. With a hook, "cuda" takes the generic stage loop: the
    direct kernel's force (``force_acc``), plus the hook, then the
    integration in PyTorch.
  * ``update_adaptive(t_span)`` (:func:`update_state_adaptive`) integrates
    a fixed physical time with a global dt chosen every substep from the
    accelerations (``diagnostics.next_adaptive_dt``). dt, the time and the
    substep count stay on the device as 0-dim tensors; substeps are
    enqueued in batches of ``ADAPTIVE_BATCH``, and a substep past the end
    keeps the state as it was. The host reads one flag a batch.
  * ``SimConfig.merge_collisions``: every substep is followed by a merge
    pass (``ops/collisions.merge_pass``; on the card its contact search is
    the kernel ``csrc/merge_contacts.cu``), and ``gm``, ``radius`` and
    ``mass`` become carried state (:func:`merging_substep`): the force of
    each substep reads the current ones, and "p3m" chooses its exact-core
    rows again at every substep.
  * Jacobi substeps: every launch reads (pos, vel) and writes new buffers,
    and the World swaps them in, as the reference double-buffers its
    storage (sim_gpu.c:19). PyTorch's caching allocator hands the freed
    pair back to the next launch.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch.profiler import record_function

from . import diagnostics, forces, integrators
from .ops.collisions import merge_pass
from .ops.direct_forces import force_acc, fused_substep
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

# Substeps the adaptive loop enqueues between two reads of its flag. A
# batch costs one host sync; the substeps of the last batch that fall past
# the end are computed and thrown away.
ADAPTIVE_BATCH = 8


def resolve_backend(backend: Backend, total_len: int, mass_len: int, *,
                    direct: Backend = "torch", merging: bool = False,
                    rebin_interval: int = 1) -> Backend:
    """Resolve ``"auto"`` by nbody_tpu's rule: ``direct`` (the device's
    direct-sum backend, where nbody_tpu answers "jnp") at or below
    AUTO_P3M_MIN_PAIRS, "p3m" above; under ``merging`` with
    ``rebin_interval > 1`` (frozen cell sorts cannot carry mid-loop mass
    changes) "pm" above. Every other backend passes through unchanged."""
    if backend != "auto":
        return backend
    if total_len * mass_len <= AUTO_P3M_MIN_PAIRS:
        return direct
    return "pm" if (merging and rebin_interval > 1) else "p3m"


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


def _scalar(value, device) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``device``, filled there (no host copy)."""
    return torch.full((), value, dtype=DTYPE, device=device)


def _mesh_sources(gm):
    """The mesh solvers' sources: max(mass_len, 1) of them (a world with no
    mass gets one inert gm = 0 source), as nbody_tpu's effective_src_len."""
    if gm.shape[0]:
        return gm
    return torch.zeros(1, dtype=DTYPE, device=gm.device)


def _gravity(backend: str, radius, gm, config: SimConfig, *, bins=None,
             softening=None):
    """``force(pos) -> acc``: self-gravity on ``backend`` for targets of
    ``radius`` and the sources ``pos[:len(gm)]``. "cuda" is the direct
    kernel's force alone (``force_acc``). "p3m" uses the frozen ``bins``
    where given, else builds fresh bins at every evaluation, as
    nbody_tpu's ``p3m_acc`` does (the exact-core rows, which depend only
    on the constant radius, are chosen once). ``softening``: the mesh's,
    a 0-dim tensor on the device, made here unless given."""
    m = gm.shape[0]
    if backend == "torch":
        return lambda p: forces.direct_sum_acc(p, radius, p[:m], gm,
                                               precise=config.precise)
    if backend == "cuda":
        return lambda p: force_acc(p, radius, p[:m], gm,
                                   precise=config.precise)
    mesh_gm = _mesh_sources(gm)
    s = mesh_gm.shape[0]
    if softening is None:
        softening = _scalar(config.pm_softening, radius.device)
    if backend == "pm":
        return lambda p: pm_acc(p, p[:s], mesh_gm, softening,
                                grid=config.pm_grid)
    if backend != "p3m":
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    big = None if bins is not None else exact_core_rows(
        radius, config.p3m_exact_targets)

    def p3m_force(p):
        return p3m_acc_from_bins(
            bins if bins is not None else _p3m_bins(p, radius, mesh_gm,
                                                    config, big),
            p, radius, p[:s], mesh_gm, softening, grid=config.pm_grid,
            rc_cells=config.p3m_rc_cells,
            cell_capacity=config.p3m_cell_capacity, precise=config.precise)
    return p3m_force


def _p3m_bins(pos, radius, mesh_gm, config: SimConfig, big):
    with record_function("p3m.bins"):
        return p3m_bins(pos, radius, pos[:mesh_gm.shape[0]], mesh_gm,
                        grid=config.pm_grid, rc_cells=config.p3m_rc_cells,
                        exact_targets=config.p3m_exact_targets, big=big)


def _step(state: Particles, gravity, dt, config: SimConfig,
          extra_force=None) -> Particles:
    """One substep of the integrator's stage loop with ``gravity(pos)``
    plus the hook. The hook sees the substep-entry ``vel`` at every stage,
    as in nbody_tpu. nbody_tpu masks the sum by its ``valid`` row; the
    port's World has no padding rows, so every row, massless ones
    included, gets the hook's acceleration. ``dt`` is a Python float or a
    0-dim tensor on the device."""
    vel0 = state.vel

    def force_at(p):
        acc = gravity(p)
        if extra_force is not None:
            acc = acc + forces.checked_extra_acc(extra_force, p, vel0)
        return acc

    pos, vel, acc = integrators.advance(config.integrator, force_at,
                                        state.pos, state.vel, dt)
    return Particles(pos=pos, vel=vel, acc=acc, mass=state.mass,
                     radius=state.radius)


def _fused_step(state: Particles, gm, dt: float, config: SimConfig) -> Particles:
    """One substep on "cuda" without a hook: one launch of the fused
    force-and-integrate kernel per DKD stage (the stage's first half-drift
    outside it)."""
    ws = integrators.stage_weights(config.integrator)
    pos, vel, acc = state.pos, state.vel, state.acc
    for w in (1.0,) if ws is None else ws:
        dtk = integrators.stage_dt(w, dt)
        pos_in = pos if ws is None else pos + (0.5 * dtk) * vel
        pos, vel, acc = fused_substep(
            dtk, pos_in, vel, state.radius, gm, precise=config.precise,
            pos_dt=1.0 if ws is None else 0.5)
    return Particles(pos=pos, vel=vel, acc=acc, mass=state.mass,
                     radius=state.radius)


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' needs a world on a CUDA device, this one is "
            f"on {device}")


def update_state(state: Particles, gm: torch.Tensor, dt: float, n: int, *,
                 config: SimConfig = DEFAULT_SIM_CONFIG, backend: Backend,
                 extra_force=None) -> Particles:
    """``n`` substeps of size ``dt`` from ``state`` (massive rows first,
    their ``gm`` = g·mass) on ``backend`` (a concrete one); returns the new
    state. The functional form of :meth:`World.update` without merging
    (:func:`update_state_merging` is the form with it): "p3m" builds its
    cell bins at the first substep and again at every substep index that
    is a multiple of ``p3m_rebin_interval``, as nbody_tpu does."""
    _check_backend(backend, state.pos.device)
    dt = float(dt)
    if backend == "cuda" and extra_force is None:
        for _ in range(n):
            state = _fused_step(state, gm, dt, config)
        return state
    if backend != "p3m":
        gravity = _gravity(backend, state.radius, gm, config)
        for _ in range(n):
            state = _step(state, gravity, dt, config, extra_force)
        return state
    state, _ = p3m_substeps(state, gm, dt, 0, n, None, config=config,
                            extra_force=extra_force)
    return state


def p3m_substeps(state: Particles, gm, dt, start: int, n: int, bins, *,
                 config: SimConfig, extra_force=None, big=None,
                 softening=None):
    """``n`` "p3m" substeps at global substep indices start, ..., start +
    n − 1, with the frozen-bins rule: the bins are built afresh where
    ``bins`` is None and at every global index that is a multiple of
    ``p3m_rebin_interval``, and every stage of a substep shares its
    substep's bins. Returns (state, bins), so that a capture loop carries
    the bins and the global index across frames (nbody_tpu's
    ``p3m_substep_loop``). ``big``: the exact-core rows, which depend only
    on the constant radius (chosen here unless given)."""
    mesh_gm = _mesh_sources(gm)
    if big is None:
        big = exact_core_rows(state.radius, config.p3m_exact_targets)
    if softening is None:
        softening = _scalar(config.pm_softening, state.pos.device)
    for i in range(start, start + n):
        if bins is None or i % config.p3m_rebin_interval == 0:
            bins = _p3m_bins(state.pos, state.radius, mesh_gm, config, big)
        gravity = _gravity("p3m", state.radius, gm, config, bins=bins,
                           softening=softening)
        state = _step(state, gravity, dt, config, extra_force)
    return state, bins


def check_merging(backend: str, config: SimConfig) -> None:
    """nbody_tpu's refusal: merging on "p3m" needs bins rebuilt at every
    substep (frozen cell sorts cannot carry mid-loop mass changes)."""
    if backend == "p3m" and config.p3m_rebin_interval > 1:
        raise ValueError(
            "merge_collisions with backend='p3m' requires "
            "p3m_rebin_interval == 1 (frozen cell blocks cannot carry "
            f"mid-loop mass changes); got {config.p3m_rebin_interval} — "
            "use rebin interval 1, or the 'pm' backend")


def merging_substep(state: Particles, gm: torch.Tensor, dt, *,
                    config: SimConfig, backend: str, extra_force=None,
                    softening=None) -> tuple[Particles, torch.Tensor]:
    """One substep, then one merge pass (``ops/collisions.merge_pass``):
    the body that :func:`update_state_merging`,
    :func:`update_state_adaptive` and trajectory capture share
    (nbody_tpu's ``merging_substep_fn``), so that those paths cannot
    drift apart. Returns (state, gm). "cuda" without a hook and with a
    float ``dt`` is one fused launch per DKD stage; every other backend,
    hooked run or tensor ``dt`` takes the stage loop with the force of the
    current radius and gm ("p3m": fresh bins at every evaluation and the
    exact-core rows chosen again, as nbody_tpu's ``p3m_acc``)."""
    if backend == "cuda" and extra_force is None and isinstance(dt, float):
        st = _fused_step(state, gm, dt, config)
    else:
        st = _step(state, _gravity(backend, state.radius, gm, config,
                                   softening=softening),
                   dt, config, extra_force)
    with record_function("merge_pass"):
        pos, vel, radius, mass, gm = merge_pass(
            st.pos, st.vel, st.radius, st.mass, gm,
            factor=config.merge_factor, g=config.g)
    return Particles(pos=pos, vel=vel, acc=st.acc, mass=mass,
                     radius=radius), gm


def update_state_merging(state: Particles, gm: torch.Tensor, dt: float,
                         n: int, *, config: SimConfig = DEFAULT_SIM_CONFIG,
                         backend: Backend, extra_force=None
                         ) -> tuple[Particles, torch.Tensor]:
    """:func:`update_state` under ``SimConfig.merge_collisions``: each
    substep is followed by a merge pass (:func:`merging_substep`), and
    ``gm`` is carried state. Returns (state, gm). "p3m" needs
    ``p3m_rebin_interval == 1`` and raises otherwise."""
    _check_backend(backend, state.pos.device)
    check_merging(backend, config)
    dt = float(dt)
    softening = _scalar(config.pm_softening, state.pos.device)
    for _ in range(n):
        state, gm = merging_substep(state, gm, dt, config=config,
                                    backend=backend, extra_force=extra_force,
                                    softening=softening)
    return state, gm


def _host(x: torch.Tensor):
    """A 0-dim tensor's value on the host: the adaptive loops' one sync a
    batch (its flag) and at the end (its count)."""
    return x.item()


def update_state_adaptive(state: Particles, gm: torch.Tensor, t_span: float,
                          *, eta: float = 0.1, dt_min: float = 1e-5,
                          dt_max: float = 1.0,
                          config: SimConfig = DEFAULT_SIM_CONFIG,
                          backend: Backend, extra_force=None
                          ) -> tuple[Particles, torch.Tensor, int]:
    """Integrate ``t_span`` physical time units with a global dt chosen
    every substep (nbody_tpu's ``update_state_adaptive``); returns (new
    state, gm, substeps taken). ``gm`` changes only under
    ``merge_collisions``.

    One priming substep with dt = 0 stores the accelerations (under
    merging it also merges, as nbody_tpu's does). Then, while t < t_span:
    dt = min(clip(criterion, max(dt_min, 1e-9), dt_max), t_span − t)
    (``diagnostics.next_adaptive_dt``), one substep, t += dt in fp32. dt,
    t and the count are 0-dim tensors on the device: the loop enqueues
    ``ADAPTIVE_BATCH`` substeps, then reads one flag (t < t_span) on the
    host. A substep past the end takes dt = 0, keeps the old state (mass,
    radius and gm too, so no merge happens there) and leaves the count as
    it was. Every backend integrates in PyTorch with the tensor dt; "cuda"
    takes its force from the direct kernel (``force_acc``), and "p3m"
    builds fresh bins at every evaluation, whatever ``p3m_rebin_interval``
    says, as nbody_tpu does."""
    device = state.pos.device
    _check_backend(backend, device)
    merging = config.merge_collisions
    if merging:
        check_merging(backend, config)
        softening = _scalar(config.pm_softening, device)

        def sub(st, gm, dt):
            return merging_substep(st, gm, dt, config=config,
                                   backend=backend, extra_force=extra_force,
                                   softening=softening)
    else:
        gravity = _gravity(backend, state.radius, gm, config)

        def sub(st, gm, dt):
            return _step(st, gravity, dt, config, extra_force), gm
    knobs = {key: _scalar(v, device) for key, v in (
        ("eta", eta), ("dt_min", dt_min), ("dt_max", dt_max),
        ("t_span", t_span))}
    state, gm = sub(state, gm, _scalar(0.0, device))
    t = _scalar(0.0, device)
    k = torch.zeros((), dtype=torch.int32, device=device)
    while True:
        for _ in range(ADAPTIVE_BATCH):
            live = t < knobs["t_span"]
            dt = torch.where(live, diagnostics.next_adaptive_dt(
                state.acc, state.radius, t=t, **knobs), 0.0)
            new, new_gm = sub(state, gm, dt)

            def keep(a, b):
                return torch.where(live, a, b)
            state = Particles(
                pos=keep(new.pos, state.pos), vel=keep(new.vel, state.vel),
                acc=keep(new.acc, state.acc),
                mass=keep(new.mass, state.mass) if merging else state.mass,
                radius=(keep(new.radius, state.radius) if merging
                        else state.radius))
            if merging:
                gm = keep(new_gm, gm)
            t = t + dt
            k = k + live.to(torch.int32)
        if not _host(t < knobs["t_span"]):
            return state, gm, _host(k)


class World:
    """Stateful wrapper mirroring the reference World ergonomics
    (nbody.h:61-73): create, update, read back. Under
    ``config.merge_collisions`` every update carries ``gm`` (and the
    state's mass and radius) through the merges: absorbed rows keep their
    place with mass 0, so ``mass_len`` is an upper bound on the rows that
    exert force, as in nbody_tpu."""

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
        backend = resolve_backend(
            backend or self._direct, self.total_len, self.mass_len,
            direct=self._direct, merging=self.config.merge_collisions,
            rebin_interval=self.config.p3m_rebin_interval)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or 'auto', "
                             f"got {backend!r}")
        return backend

    def update(self, dt: float, n: int = 1, backend: Backend | None = None,
               extra_force=None) -> "World":
        """n substeps of size dt on ``backend`` (default: the world's
        ``default_backend``; "auto" resolves as :func:`resolve_backend`
        says), see :func:`update_state`. ``extra_force(pos, vel) -> acc``
        optionally adds a user acceleration field (external potential,
        drag, thrust) on top of self-gravity; it must return (N, 2). Under
        merging, see :func:`update_state_merging`."""
        backend = self._resolve(backend or self.default_backend)
        _check_backend(backend, self.device)
        if n <= 0:
            return self
        if self.config.merge_collisions:
            self.state, self.gm = update_state_merging(
                self.state, self.gm, dt, n, config=self.config,
                backend=backend, extra_force=extra_force)
        else:
            self.state = update_state(self.state, self.gm, dt, n,
                                      config=self.config, backend=backend,
                                      extra_force=extra_force)
        self._host_cache = None
        return self

    def update_adaptive(self, t_span: float, *, eta: float = 0.1,
                        dt_min: float = 1e-5, dt_max: float = 1.0,
                        backend: Backend | None = None,
                        extra_force=None) -> int:
        """Integrate ``t_span`` physical time units with per-substep
        adaptive dt (see :func:`update_state_adaptive`); returns the number
        of substeps taken."""
        backend = self._resolve(backend or self.default_backend)
        self.state, self.gm, k = update_state_adaptive(
            self.state, self.gm, t_span, eta=eta, dt_min=dt_min,
            dt_max=dt_max, config=self.config, backend=backend,
            extra_force=extra_force)
        self._host_cache = None
        return k

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
