"""State checkpoints and resume: the .npz file of
``nbody_tpu/utils/checkpoint.py``, and its shard-native checkpoints on
``torch.distributed.checkpoint`` in place of Orbax.

The .npz file has the same keys (``pos``, ``vel``, ``acc``, ``mass``,
``radius``, then ``step``, ``mass_len`` and ``sim_config`` as JSON), so a
checkpoint written by either package loads in the other; it moves the
whole state through the host. Fields of a saved ``SimConfig`` that the
reader's ``SimConfig`` lacks are dropped (:func:`config_from_dict`).

The shard-native checkpoint (:func:`save_world_dcp`,
:func:`load_sharded_world_dcp`, :func:`load_world_dcp`) is a directory:
``meta`` (step, total_len, mass_len, n_pad, n_devices), ``arrays`` (the
PADDED state, one item a field a shard: ``pos.<k>`` for global shard k)
and ``config.json`` (the SimConfig, ``{"format": 1, "sim_config": ...}``
as ``nbody_tpu`` writes it). Each process writes only its own shards,
straight from their tensors, and a restore onto the same layout reads
each shard straight onto its device: no path gathers the state onto one
device or the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings

import numpy as np
import torch

from ..interop import FIELDS, particles_from_numpy, to_numpy
from ..types import DEFAULT_SIM_CONFIG, DTYPE, Particles, SimConfig


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


def _host_state(world) -> tuple[Particles, bool]:
    """The world's N real rows on the host, and whether this process
    writes them: a ShardedWorld over several processes gathers them
    (``multihost.gather_particles``, every rank joining) and only rank 0
    writes."""
    group = getattr(world, "group", None)
    if group is None or group.size == 1:
        return world.particles, True
    from ..parallel.multihost import gather_particles

    return gather_particles(world), group.rank == 0


def save_world(path: str, world, step: int = 0) -> None:
    """Checkpoint a World or ShardedWorld: its N real rows (host copy),
    the step counter, ``mass_len`` and the SimConfig, so that a resume
    rebuilds the same physics without the caller supplying it again. A
    ShardedWorld over several processes is gathered from every rank (each
    must call) and written by rank 0; it restores on a single-process
    world (:func:`load_world` with ``ShardedWorld`` and a mesh)."""
    particles, writer = _host_state(world)
    if writer:
        save_particles(path, particles, **_world_extra(world, step))


def save_world_atomic(path: str, world, step: int = 0) -> None:
    """Crash-safe checkpoint: write a temporary .npz in the target's
    directory, fsync it, then rename it over ``path`` (POSIX rename), so a
    process killed mid-write never leaves a half-written file in place of
    the last good one. The file gets the mode a plain ``open`` would give
    it under the current umask. Over several processes, as
    :func:`save_world`."""
    particles, writer = _host_state(world)
    if not writer:
        return
    target = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", prefix=".ckpt-", dir=os.path.dirname(target) or ".")
    os.close(fd)
    try:
        os.chmod(tmp, 0o666 & ~_current_umask())
        save_particles(tmp, particles, **_world_extra(world, step))
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


# --- shard-native checkpoints (torch.distributed.checkpoint) -------------
#
# The counterparts of nbody_tpu's Orbax paths (nbody_tpu/utils/
# checkpoint.py:130-340). Layout: <path>/meta, <path>/arrays and
# <path>/config.json (the module's docstring).

META_KEYS = ("step", "total_len", "mass_len", "n_pad", "n_devices")


def _dcp(fn, state: dict, pg, **where) -> None:
    """``dcp.save`` or ``dcp.load`` of ``state``: over the process group
    ``pg`` (every rank calling), or in this process alone."""
    with warnings.catch_warnings():  # both are what the caller asks for
        warnings.filterwarnings("ignore", message="Detected an existing "
                                "checkpoint")
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        if pg is None:
            fn(state, no_dist=True, **where)
        else:
            fn(state, process_group=pg, **where)


def _save(state: dict, path: str, pg=None) -> None:
    """Write ``state`` at ``path``, over an earlier checkpoint there."""
    import torch.distributed.checkpoint as dcp

    _dcp(dcp.save, state, pg,
         storage_writer=dcp.FileSystemWriter(path, overwrite=True))


def _load(state: dict, path: str, pg=None) -> None:
    """Fill the tensors of ``state`` in place from ``path``."""
    import torch.distributed.checkpoint as dcp

    _dcp(dcp.load, state, pg, checkpoint_id=path)


def _world_group(world) -> tuple:
    """(process group or None, this process's rank) of a world."""
    group = getattr(world, "group", None)
    pg = None if group is None else group.pg
    return pg, (0 if pg is None else group.rank)


def _shard_items(world) -> dict:
    """This process's shards as DCP items, ``<field>.<global shard>``: the
    shards' own tensors (a World is one shard)."""
    if not hasattr(world, "n_devices"):
        return {f"{f}.0": getattr(world.state, f) for f in FIELDS}
    return {f"{f}.{world.first + j}": x for f in FIELDS
            for j, x in enumerate(getattr(world, f))}


def _meta_tree(world, step: int) -> dict:
    """The checkpoint's scalars as 0-dim int64 CPU tensors (a World has no
    padding and is one shard)."""
    sharded = hasattr(world, "n_devices")
    values = (step, world.total_len, world.mass_len,
              world.n_pad if sharded else world.total_len,
              world.n_devices if sharded else 1)
    return {k: torch.tensor(int(v), dtype=torch.int64)
            for k, v in zip(META_KEYS, values)}


def save_world_dcp(path: str, world, step: int = 0) -> None:
    """Checkpoint a World, or a ShardedWorld in one process or over a
    ``torch.distributed`` group (every rank calling), with each process
    writing only its own shards' bytes: the counterpart of
    ``nbody_tpu``'s ``save_world_orbax``. Rank 0 writes ``meta`` and the
    ``config.json`` sidecar, and drops a stale sidecar before the arrays
    are written, so a save cut short never pairs new arrays with an old
    config. Over a group every rank returns once all of it is written."""
    base = os.path.abspath(path)
    pg, rank = _world_group(world)
    if rank == 0:
        os.makedirs(base, exist_ok=True)
        _drop_config_sidecar(base)
        _save(_meta_tree(world, step), os.path.join(base, "meta"))
    _save(_shard_items(world), os.path.join(base, "arrays"), pg)
    if rank == 0:
        _save_config_sidecar(base, world.config)
    if pg is not None:  # every rank returns once the checkpoint is whole
        import torch.distributed as dist

        dist.barrier(group=pg)


def _drop_config_sidecar(base: str) -> None:
    try:
        os.unlink(os.path.join(base, "config.json"))
    except FileNotFoundError:
        pass


def _save_config_sidecar(base: str, config) -> None:
    """Write <base>/config.json through a rename, so that a reader never
    sees a partial file."""
    payload = {"format": 1, "sim_config": dataclasses.asdict(config)}
    fd, tmp = tempfile.mkstemp(prefix=".config-", dir=base)
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, os.path.join(base, "config.json"))


def _load_config_sidecar(base: str):
    """SimConfig from <base>/config.json, or None where there is none. An
    unreadable sidecar warns and gives None: the checkpoint stays
    loadable, and a wrong layout is caught by the n_pad check."""
    sidecar = os.path.join(base, "config.json")
    try:
        with open(sidecar) as f:
            payload = json.load(f)
        return config_from_dict(payload["sim_config"])
    except FileNotFoundError:
        return None
    except Exception as e:
        warnings.warn(f"ignoring unreadable checkpoint config sidecar "
                      f"{sidecar} ({type(e).__name__}: {e}); pass config= "
                      "explicitly to silence", stacklevel=3)
        return None


def _read_meta(base: str) -> dict:
    meta_dir = os.path.join(base, "meta")
    if not os.path.isdir(meta_dir):
        raise FileNotFoundError(f"{base} is not a meta+arrays checkpoint "
                                "of save_world_dcp")
    meta = {k: torch.zeros((), dtype=torch.int64) for k in META_KEYS}
    _load(meta, meta_dir)
    return {k: int(v) for k, v in meta.items()}


def load_sharded_world_dcp(path: str, mesh, *, config=None,
                           force_backend=None, group=None):
    """Resume a ShardedWorld with each shard read straight onto its
    device: the counterpart of ``nbody_tpu``'s ``load_sharded_world_orbax``.
    Each shard's tensors are allocated on ``mesh[k]`` and filled in place
    by ``dcp.load``; no state row crosses devices or reaches the host.
    With ``group`` (a ``torch.distributed`` process group, every rank
    calling) ``mesh`` is this rank's devices and each rank reads only its
    own shards. ``config=None`` takes the save-time SimConfig from the
    sidecar (none: the default config). The mesh size and config must give
    the saved padded layout, else ``ValueError``; a resize goes through
    :func:`load_world_dcp`. Returns (world, step)."""
    from ..parallel.sharding import (ShardedWorld, make_mesh, shard_group,
                                     shard_layout)

    base = os.path.abspath(path)
    config = config or _load_config_sidecar(base) or DEFAULT_SIM_CONFIG
    meta = _read_meta(base)
    devices = make_mesh(devices=mesh)
    sg = None if group is None else shard_group(group, devices)
    d = len(devices) * (1 if sg is None else sg.size)
    n, mass_len = meta["total_len"], meta["mass_len"]
    _, t_loc, _, n_pad = shard_layout(n, mass_len, config, d)
    if (n_pad, d) != (meta["n_pad"], meta["n_devices"]):
        raise ValueError(
            f"checkpoint was saved with padded size {meta['n_pad']} over "
            f"{meta['n_devices']} shards; this mesh/config gives {n_pad} over "
            f"{d}: restore with the same mesh size and tile config, or go "
            "through load_world_dcp (host path)")
    shards = {f: [torch.empty((t_loc, 2) if f in ("pos", "vel", "acc")
                              else (t_loc,), dtype=DTYPE, device=dev)
                  for dev in devices] for f in FIELDS}
    first = 0 if sg is None else sg.first(len(devices))
    _load({f"{f}.{first + j}": x for f, xs in shards.items()
           for j, x in enumerate(xs)},
          os.path.join(base, "arrays"), None if sg is None else sg.pg)
    world = ShardedWorld._from_shards(
        shards, total_len=n, mass_len=mass_len, devices=devices,
        config=config, force_backend=force_backend, group=sg)
    return world, meta["step"]


def load_world_dcp(path: str, world_cls=None, **world_kwargs):
    """Resume any world class from a :func:`save_world_dcp` checkpoint
    through the host: every shard is read to the CPU, the shards joined
    in order and cut to ``total_len`` rows, and ``world_cls(particles,
    **world_kwargs)`` built (default the port's World; ``ShardedWorld``
    with ``mesh=`` re-shards onto any mesh). The counterpart of
    ``nbody_tpu``'s ``load_world_orbax``, and the path of a resize.
    Without ``config=`` the sidecar's SimConfig is used where the class
    takes one. Returns (world, step)."""
    import torch.distributed.checkpoint as dcp

    if world_cls is None:
        from ..world import World as world_cls  # noqa: N813
    base = os.path.abspath(path)
    meta = _read_meta(base)
    arrays = os.path.join(base, "arrays")
    saved = dcp.FileSystemReader(arrays).read_metadata().state_dict_metadata
    items = {k: torch.empty(tuple(v.size), dtype=v.properties.dtype)
             for k, v in saved.items()}
    _load(items, arrays)
    n = meta["total_len"]
    p = Particles(**{f: torch.cat([items[f"{f}.{k}"] for k in
                                   range(meta["n_devices"])])[:n].contiguous()
                     for f in FIELDS})
    if "config" not in world_kwargs and _accepts_config(world_cls):
        config = _load_config_sidecar(base)
        if config is not None:
            world_kwargs["config"] = config
    return world_cls(p, **world_kwargs), meta["step"]
