"""Trajectory capture and observable streaming, frames stacked on the device.

Counterpart of ``nbody_tpu/trajectory.py``. JAX runs a whole animation in
one jitted ``lax.scan``; here each frame is a Python loop of substeps on
the device, its capture (positions by default) is kept there, and the
frames are stacked on the device and copied to the host once, at the end.
Nothing in the loop waits for the host.

"p3m" keeps its frozen-bins rule across frames: the bins and the global
substep index are carried from one frame to the next, so the bins rebuild
at the same substeps as in one ``update`` call of frames × steps_per_frame
substeps (nbody_tpu's ``p3m_substep_loop``). Under
``SimConfig.merge_collisions`` every substep is
``world.merging_substep``, the body ``update`` uses, and ``gm`` is
returned.
"""

from __future__ import annotations

import numpy as np
import torch

from . import diagnostics
from .ops.p3m_forces import exact_core_rows
from .types import Particles, SimConfig


def stack_frames(frames: list):
    """A list of per-frame captures (tensors, or dicts, lists and tuples of
    them) stacked along a new leading axis, leaf by leaf, on their
    device."""
    first = frames[0]
    if isinstance(first, dict):
        return {k: stack_frames([f[k] for f in frames]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_frames([f[i] for f in frames])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(f) for f in frames])


def _positions(st: Particles, gm) -> torch.Tensor:
    del gm
    return st.pos


def record_states(state: Particles, gm: torch.Tensor, dt: float, *,
                  frames: int, steps_per_frame: int, config: SimConfig,
                  backend: str, extra_force=None, capture=None):
    """Run frames × steps_per_frame substeps on ``backend`` (a concrete
    one); return (final state, final gm, captured) where ``captured``
    stacks ``capture(state, gm)`` once per frame along a new leading axis
    on the device (default: positions, (frames, N, 2)). ``gm`` changes only
    under ``config.merge_collisions``; it is returned in every case so that
    callers have one contract."""
    from .world import (_check_backend, _scalar, check_merging,
                        merging_substep, p3m_substeps, update_state)

    if frames < 1:
        raise ValueError(f"frames must be >= 1, got {frames}")
    _check_backend(backend, state.pos.device)
    cap = capture if capture is not None else _positions
    dt = float(dt)
    out = []
    if config.merge_collisions:
        check_merging(backend, config)
        softening = _scalar(config.pm_softening, state.pos.device)
        for _ in range(frames):
            for _ in range(steps_per_frame):
                state, gm = merging_substep(
                    state, gm, dt, config=config, backend=backend,
                    extra_force=extra_force, softening=softening)
            out.append(cap(state, gm))
    elif backend == "p3m":
        big = exact_core_rows(state.radius, config.p3m_exact_targets)
        softening = _scalar(config.pm_softening, state.pos.device)
        bins = None
        for f in range(frames):
            state, bins = p3m_substeps(
                state, gm, dt, f * steps_per_frame, steps_per_frame, bins,
                config=config, extra_force=extra_force, big=big,
                softening=softening)
            out.append(cap(state, gm))
    else:
        for _ in range(frames):
            state = update_state(state, gm, dt, steps_per_frame,
                                 config=config, backend=backend,
                                 extra_force=extra_force)
            out.append(cap(state, gm))
    return state, gm, stack_frames(out)


def _record(world, dt, frames, steps_per_frame, backend, extra_force,
            capture):
    backend = world._resolve(backend or world.default_backend)
    state, gm, captured = record_states(
        world.state, world.gm, dt, frames=frames,
        steps_per_frame=steps_per_frame, config=world.config,
        backend=backend, extra_force=extra_force, capture=capture)
    world.state, world.gm = state, gm
    world._host_cache = None
    return captured


def record_trajectory(world, dt: float, frames: int, steps_per_frame: int = 1,
                      backend: str | None = None,
                      extra_force=None) -> np.ndarray:
    """Advance ``world`` by frames × steps_per_frame substeps and return the
    positions after each frame as a host array (frames, total_len, 2). The
    world's state is updated. ``extra_force(pos, vel) -> acc`` composes a
    user field with self-gravity, as ``World.update``'s hook."""
    traj = _record(world, dt, frames, steps_per_frame, backend, extra_force,
                   None)
    return traj[:, :world.total_len].cpu().numpy()


def record_observables(world, dt: float, frames: int,
                       steps_per_frame: int = 1, backend: str | None = None,
                       extra_force=None, energy: str | None = "exact",
                       capture=None, **capture_kw) -> dict:
    """Advance ``world`` by frames × steps_per_frame substeps, capturing
    the conserved quantities once per frame (kinetic and potential energy,
    momentum, angular momentum, center of mass; see
    ``diagnostics.observables_capture``) instead of positions. ``energy``
    picks the potential estimator ("exact", "pm" or None); a custom
    ``capture(state, gm)`` replaces the default set, and is rejected
    together with a non-default ``energy`` or extra keywords. Returns host
    numpy arrays keyed by observable, plus ``"time"``: the simulation time
    at each frame. The world's state is updated."""
    diagnostics.check_observables_args(capture, energy, capture_kw)
    if capture is None:
        capture = diagnostics.observables_capture(world.mass_len,
                                                  energy=energy, **capture_kw)
    series = _record(world, dt, frames, steps_per_frame, backend,
                     extra_force, capture)
    return diagnostics.observables_series_out(series, frames,
                                              steps_per_frame, dt)


def record_trajectory_sharded(world, dt: float, frames: int,
                              steps_per_frame: int = 1,
                              extra_force=None) -> np.ndarray:
    """Trajectory capture for a ShardedWorld, the same contract as
    :func:`record_trajectory`: :meth:`ShardedWorld.record`."""
    return world.record(dt, frames, steps_per_frame, extra_force=extra_force)


def save_trajectory(path: str, traj, **extra) -> None:
    np.savez_compressed(path, traj=np.asarray(traj, np.float32), **extra)


def load_trajectory(path: str) -> tuple[np.ndarray, dict]:
    with np.load(path) as data:
        traj = data["traj"]
        extra = {k: data[k] for k in data.files if k != "traj"}
    return traj, extra
