"""Differentiable simulation rollouts: reverse-mode gradients through whole
trajectories. Counterpart of ``nbody_tpu/autodiff.py``.

``rollout`` runs ``n_steps`` substeps as a Python loop (JAX's
``lax.scan``) and is differentiable with respect to the initial positions
and velocities, the masses, the radii, ``dt`` and the parameters of a
force hook. ``remat=True`` wraps each step (for "p3m" each block of
``p3m_rebin_interval`` steps) in ``torch.utils.checkpoint.checkpoint``
(JAX's ``jax.checkpoint``), so the backward keeps O(N) a step and
recomputes the step's forward when it reaches it. Every force the port
computes gives the same bits when it is recomputed, so ``remat`` changes no
value.

Backends take the port's names, as ``World`` does:

* "torch" (JAX's "jnp"): the plain direct sum, differentiated by autograd;
* "cuda" (JAX's "pallas"): the direct kernel (``ops/direct_forces``'s
  ``force_acc``) forward and its VJP kernels (``csrc/direct_vjp.cu``)
  backward, saving only the step's inputs. It takes any N, so nothing is
  padded. It needs CUDA tensors, as ``World`` does;
* "pm": the particle mesh, plain PyTorch, differentiated by autograd;
* "p3m": the mesh plus the pair correction (``p3m_pp.pp_cells``: K4
  forward, its VJP kernels ``csrc/p3m_pp_vjp.cu`` backward on the card)
  and the exact-core rows (``force_acc``), through frozen bins built at
  each block's start from detached positions.

``rollout_sharded`` is the single-controller form over a list of devices
(``parallel.sharding.make_mesh``): on "torch" and "cuda" each shard's rows
and gm visit every shard round the ring, each hop a direct sum; on "pm"
and "p3m" each force is the collective mesh solver
(``ops/pm_forces.pm_acc_collective``, ``ops/p3m_forces.p3m_acc_collective``),
whose shard sums and copies between devices carry the gradient back.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import forces, integrators, world
from .ops.direct_forces import force_acc
from .ops.p3m_forces import (exact_core_rows, p3m_acc_collective,
                              p3m_acc_from_bins, p3m_bins)
from .ops.pm_forces import pm_acc, pm_acc_collective
from .parallel.sharding import Shards, make_mesh, shard_layout
from .types import DEFAULT_SIM_CONFIG, DTYPE, G, Particles
from .world import BACKENDS


def _hook(extra_force, params):
    """The user hook's acceleration as a function of (pos, vel), or None."""
    if extra_force is None:
        return None
    if params is None:
        return lambda p, v: forces.checked_extra_acc(extra_force, p, v)
    return lambda p, v: forces.checked_extra_acc(extra_force, p, v, params)


def _advance(integrator, force, hook, pos, vel, dt):
    """One substep of ``integrator`` (``integrators.advance``) with the
    hook's term added to ``force``; the hook sees the substep-entry ``vel``,
    as the World's step. Returns (pos, vel)."""
    if hook is not None:
        gravity = force

        def force(p):
            return gravity(p) + hook(p, vel)

    pos, vel, _ = integrators.advance(integrator, force, pos, vel, dt)
    return pos, vel


def _as_dt(dt, device) -> torch.Tensor:
    """dt as a 0-dim fp32 tensor on ``device`` (a tensor keeps its graph)."""
    if isinstance(dt, torch.Tensor):
        return dt.to(device=device, dtype=DTYPE)
    return torch.full((), float(dt), dtype=DTYPE, device=device)


def _remat(fn, remat: bool):
    """``fn`` itself, or ``fn`` recomputed in the backward (no RNG state is
    kept: nothing in a step draws random numbers)."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def rollout(
    pos: torch.Tensor,
    vel: torch.Tensor,
    mass: torch.Tensor,
    radius: torch.Tensor,
    dt,
    *,
    n_steps: int,
    mass_len: int,
    precise: bool = True,
    remat: bool = True,
    g: float = G,
    backend: str = "torch",
    pm_grid: int = 512,
    pm_softening: float = 2.0,
    p3m_rc_cells: int = 4,
    p3m_cell_capacity: int = 96,
    p3m_exact_targets: int = 64,
    p3m_rebin_interval: int = 1,
    p3m_pp_chunk: int = 0,
    integrator: str = "euler",
    extra_force=None,
    extra_force_params=None,
):
    """Differentiable ``n_steps``-substep rollout; returns the final
    (pos, vel). Inputs are fp32 tensors on one device in massive-first
    order (sources = rows [0, mass_len)), gm = g·mass of those rows.
    Differentiable with respect to ``pos``, ``vel``, ``mass``, ``radius``,
    ``dt`` (a float, or a 0-dim fp32 tensor that may require grad) and
    ``extra_force_params``.

    ``integrator``: "euler" (the reference's), "leapfrog" or "yoshida4",
    each a composition of the force closure, so gradients flow through
    each alike.

    ``extra_force(pos, vel)``, or ``extra_force(pos, vel,
    extra_force_params)`` when params are given, adds a user acceleration
    field to self-gravity; ``vel`` is the substep-entry velocity. Gradients
    reach any tensors in ``extra_force_params``.

    "p3m" builds its bins from detached positions at the start of each
    block of ``p3m_rebin_interval`` steps; positions are read fresh through
    them. ``p3m_pp_chunk`` is accepted and changes nothing: the port's pair
    correction has no chunk skip, so its gradient with respect to the mass
    of a massless source is always the exact, unchunked one (JAX's with
    ``p3m_pp_chunk=0``, its default here)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown rollout backend {backend!r}; expected one "
                         f"of {BACKENDS}")
    device = pos.device
    if backend == "cuda":
        world._check_backend(backend, device)
    integrators.stage_weights(integrator)  # raises on an unknown one
    dt = _as_dt(dt, device)
    radius = radius.contiguous()
    gm = (g * mass)[:mass_len]
    hook = _hook(extra_force, extra_force_params)

    def advance(force, p, v):
        return _advance(integrator, force, hook, p, v, dt)

    if backend == "p3m":
        return _p3m_rollout(pos, vel, radius, gm, advance, n_steps=n_steps,
                            remat=remat, precise=precise, grid=pm_grid,
                            softening=pm_softening, rc_cells=p3m_rc_cells,
                            capacity=p3m_cell_capacity,
                            exact_targets=p3m_exact_targets,
                            rebin=max(p3m_rebin_interval, 1))
    if backend == "torch":
        def force(p):
            return forces.direct_sum_acc(p, radius, p[:mass_len], gm,
                                         precise=precise)
    elif backend == "cuda":
        def force(p):
            return force_acc(p, radius, p[:mass_len], gm, precise=precise)
    else:
        mesh_gm = world._mesh_sources(gm)
        s = mesh_gm.shape[0]
        softening = world._scalar(pm_softening, device)

        def force(p):
            return pm_acc(p, p[:s], mesh_gm, softening, grid=pm_grid)

    step = _remat(lambda p, v: advance(force, p, v), remat)
    for _ in range(n_steps):
        pos, vel = step(pos, vel)
    return pos, vel


def _p3m_rollout(pos, vel, radius, gm, advance, *, n_steps, remat, precise,
                 grid, softening, rc_cells, capacity, exact_targets, rebin):
    """The "p3m" rollout: blocks of ``rebin`` steps (a shorter last one),
    each with bins frozen at its start, each block rematerialized as a
    whole."""
    mesh_gm = world._mesh_sources(gm)
    s = mesh_gm.shape[0]
    soft = world._scalar(softening, pos.device)
    big = exact_core_rows(radius, exact_targets)

    def block(p, v, steps):
        bins = p3m_bins(p.detach(), radius, p[:s].detach(), mesh_gm.detach(),
                        grid=grid, rc_cells=rc_cells,
                        exact_targets=exact_targets, big=big)

        def force(q):
            return p3m_acc_from_bins(bins, q, radius, q[:s], mesh_gm, soft,
                                     grid=grid, rc_cells=rc_cells,
                                     cell_capacity=capacity, precise=precise)

        for _ in range(steps):
            p, v = advance(force, p, v)
        return p, v

    full = _remat(lambda p, v: block(p, v, rebin), remat)
    for _ in range(n_steps // rebin):
        pos, vel = full(pos, vel)
    if n_steps % rebin:
        rest = _remat(lambda p, v: block(p, v, n_steps % rebin), remat)
        pos, vel = rest(pos, vel)
    return pos, vel


def rollout_sharded(
    pos, vel, mass, radius, dt, *,
    n_steps: int,
    mass_len: int,
    mesh,
    backend: str = "torch",
    precise: bool = True,
    remat: bool = True,
    g: float = G,
    pm_grid: int = 512,
    pm_softening: float = 2.0,
    p3m_rc_cells: int = 4,
    p3m_cell_capacity: int = 96,
    p3m_exact_targets: int = 64,
    p3m_pp_chunk: int = 0,
    integrator: str = "euler",
    extra_force=None,
    extra_force_params=None,
):
    """Differentiable rollout sharded over a 1-D mesh (a list of devices,
    ``make_mesh``; it may repeat one device), driven by one process.

    The N rows are padded to ``shard_layout``'s D·t_loc rows (padding rows
    as ``padded_state`` makes them: zero pos and vel, radius 1, gm 0) and
    split into D shards. On "torch" and "cuda" each force evaluation is the
    ring of resident tiles: at hop h shard k meets the rows and gm of shard
    (k − h) mod D (JAX's ``ppermute`` order), each hop a direct sum
    ("torch": plain; "cuda": ``force_acc`` and its VJP kernels), massless
    and padding rows exerting exactly zero. On "pm" and "p3m" it is the
    collective mesh solver with ``pm_grid``, ``pm_softening`` and the
    ``p3m_*`` knobs, its bins built afresh at every evaluation from
    detached positions, as nbody_tpu's ``p3m_acc_collective``; on CUDA
    shards "p3m"'s pair correction is K4 (``pp_cells``) on each shard,
    backward through its VJP kernel with the same cut counts. The sum and
    the hook's term are masked by the ``valid`` rows. The hook sees one
    shard's rows. Gradients flow back through the shard sums and the
    copies between devices. Returns the global (pos, vel) of the N real
    rows on ``pos``'s device.

    ``p3m_pp_chunk`` is accepted and changes nothing: the port's pair
    correction has no chunk skip."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown sharded rollout backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    devices = make_mesh(devices=mesh)
    if backend == "cuda":
        for dev in devices:
            world._check_backend(backend, dev)
    integrators.stage_weights(integrator)
    d = len(devices)
    n = pos.shape[0]
    _, t_loc, _, n_pad = shard_layout(n, mass_len, DEFAULT_SIM_CONFIG, d)
    home = pos.device
    extra = n_pad - n
    rows = torch.arange(n_pad, device=home)
    gm = torch.where(rows[:n] < mass_len, g * mass, 0.0)

    def split(a):
        return [a[k * t_loc:(k + 1) * t_loc].to(dev)
                for k, dev in enumerate(devices)]

    ps = split(torch.cat([pos, pos.new_zeros((extra, 2))]))
    vs = split(torch.cat([vel, vel.new_zeros((extra, 2))]))
    gms = split(torch.cat([gm, gm.new_zeros(extra)]))
    rads = split(torch.cat([radius, radius.new_ones(extra)]))
    valids = split((rows < n).to(DTYPE)[:, None])
    dts = [_as_dt(dt, dev) for dev in devices]

    def direct(p, r, sp, sg):
        if backend == "cuda":
            return force_acc(p, r, sp, sg, precise=precise)
        return forces.direct_sum_acc(p, r, sp, sg, precise=precise)

    hook = _hook(extra_force, extra_force_params)

    def ring_force(ps_):
        out = []
        for k, dev in enumerate(devices):
            acc = torch.zeros_like(ps_[k])
            for hop in range(d):
                src = (k - hop) % d
                acc = acc + direct(ps_[k], rads[k], ps_[src].to(dev),
                                   gms[src].to(dev))
            out.append(acc * valids[k])
        return Shards(out)

    # the mesh solvers' sources: each shard's rows of the first
    # max(mass_len, 1) rows, as ShardedWorld's
    src_rows = [min(max(max(mass_len, 1) - k * t_loc, 0), t_loc)
                for k in range(d)]
    softening = [world._scalar(pm_softening, dev) for dev in devices]

    def mesh_force(ps_):
        src = [p[:r] for p, r in zip(ps_, src_rows)]
        sg = [x[:r] for x, r in zip(gms, src_rows)]
        if backend == "pm":
            acc = pm_acc_collective(list(ps_), src, sg, softening,
                                    grid=pm_grid, tgt_mask=valids)
        else:
            acc = p3m_acc_collective(
                list(ps_), rads, src, sg, softening, grid=pm_grid,
                rc_cells=p3m_rc_cells, cell_capacity=p3m_cell_capacity,
                exact_targets=p3m_exact_targets, precise=precise,
                tgt_mask=valids)
        return Shards(a * m for a, m in zip(acc, valids))

    def masked_hook(ps_, vs_):
        return Shards(hook(p, v) * m for p, v, m in zip(ps_, vs_, valids))

    force = mesh_force if backend in ("pm", "p3m") else ring_force

    def step(*state):
        p, v = _advance(integrator, force,
                        None if hook is None else masked_hook,
                        Shards(state[:d]), Shards(state[d:]), Shards(dts))
        return (*p, *v)

    step = _remat(step, remat)
    state = (*ps, *vs)
    for _ in range(n_steps):
        state = step(*state)

    def gather(xs):
        return torch.cat([x.to(home) for x in xs])[:n]

    return gather(state[:d]), gather(state[d:])


def rollout_particles(particles: Particles, dt, n_steps: int, mass_len: int,
                      **kw) -> Particles:
    """:func:`rollout` of a ``Particles`` state: the final positions and
    velocities, with ``acc``, ``mass`` and ``radius`` passed through."""
    pos, vel = rollout(particles.pos, particles.vel, particles.mass,
                       particles.radius, dt, n_steps=n_steps,
                       mass_len=mass_len, **kw)
    return Particles(pos=pos, vel=vel, acc=particles.acc,
                     mass=particles.mass, radius=particles.radius)


def trajectory_loss(target_pos, index: int):
    """Loss factory: the squared distance of particle ``index`` from
    ``target_pos`` at the end of the rollout (the 'aim the tracer'
    objective). The loss takes :func:`rollout`'s arguments."""

    def loss(pos0, vel0, mass, radius, dt, *, n_steps, mass_len, **kw):
        pos, _ = rollout(pos0, vel0, mass, radius, dt, n_steps=n_steps,
                         mass_len=mass_len, **kw)
        target = torch.as_tensor(target_pos, dtype=DTYPE, device=pos.device)
        return torch.sum((pos[index] - target) ** 2)

    return loss
