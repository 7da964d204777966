"""State checkpoint and resume (.npz), the file format of
``nbody_tpu/utils/checkpoint.py``: the same keys (``pos``, ``vel``,
``acc``, ``mass``, ``radius``, then ``step``, ``mass_len`` and
``sim_config`` as JSON), so that a checkpoint written by either package
loads in the other. Fields of a saved ``SimConfig`` that the reader's
``SimConfig`` lacks are dropped (:func:`config_from_dict`). The Orbax paths
are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings

import numpy as np

from ..interop import FIELDS, particles_from_numpy, to_numpy
from ..types import Particles, SimConfig


def save_particles(path: str, particles: Particles, **extra) -> None:
    """Save particle state (+ optional metadata scalars) to an .npz file."""
    np.savez_compressed(path, **to_numpy(particles), **extra)


def load_particles(path: str) -> tuple[Particles, dict]:
    """Load particle state as CPU tensors; returns (particles, extra
    metadata)."""
    with np.load(path) as data:
        p = particles_from_numpy(*(data[k] for k in FIELDS), device="cpu")
        extra = {k: data[k] for k in data.files if k not in FIELDS}
    return p, extra


def _config_json(config) -> str:
    return json.dumps(dataclasses.asdict(config))


def _world_extra(world, step: int) -> dict:
    return dict(step=np.int64(step), mass_len=np.int64(world.mass_len),
                sim_config=_config_json(world.config))


def save_world(path: str, world, step: int = 0) -> None:
    """Checkpoint a World or ShardedWorld: its N real rows (host copy),
    the step counter, ``mass_len`` and the SimConfig, so that a resume
    rebuilds the same physics without the caller supplying it again."""
    save_particles(path, world.particles, **_world_extra(world, step))


def save_world_atomic(path: str, world, step: int = 0) -> None:
    """Crash-safe checkpoint: write a temporary .npz in the target's
    directory, fsync it, then rename it over ``path`` (POSIX rename), so a
    process killed mid-write never leaves a half-written file in place of
    the last good one. The file gets the mode a plain ``open`` would give
    it under the current umask."""
    target = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", prefix=".ckpt-", dir=os.path.dirname(target) or ".")
    os.close(fd)
    try:
        os.chmod(tmp, 0o666 & ~_current_umask())
        save_particles(tmp, world.particles, **_world_extra(world, step))
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _current_umask() -> int:
    mask = os.umask(0)
    os.umask(mask)
    return mask


def load_world(path: str, world_cls=None, **world_kwargs):
    """Resume a World from a checkpoint: returns (world, step). Without
    ``config=``, the checkpoint's saved SimConfig is used (where the world
    class takes one). ``world_kwargs`` go to the world class (``device=``
    for the port's World, "cuda" by default)."""
    if world_cls is None:
        from ..world import World as world_cls  # noqa: N813
    p, extra = load_particles(path)
    if ("sim_config" in extra and "config" not in world_kwargs
            and _accepts_config(world_cls)):
        saved = saved_config(extra)
        if saved is not None:
            world_kwargs["config"] = saved
    return world_cls(p, **world_kwargs), int(extra.get("step", 0))


def saved_config(extra: dict):
    """SimConfig from :func:`load_particles` metadata, or None (absent or
    unreadable, with a warning)."""
    if "sim_config" not in extra:
        return None
    try:
        return config_from_dict(json.loads(str(np.asarray(
            extra["sim_config"]).item())))
    except Exception as e:
        warnings.warn(f"ignoring unreadable sim_config in checkpoint "
                      f"({type(e).__name__}: {e}); pass config= explicitly "
                      "to silence", stacklevel=3)
        return None


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from a saved field dict. Keys that this SimConfig lacks
    (fields of the other package, or of a newer writer) are dropped and the
    rest honoured."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    return SimConfig(**{k: v for k, v in d.items() if k in known})


def _accepts_config(world_cls) -> bool:
    """Whether ``world_cls(particles, config=...)`` is valid."""
    import inspect

    try:
        params = inspect.signature(world_cls).parameters
    except (TypeError, ValueError):
        return False
    return "config" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
