"""Multi-process operation: one simulation over the processes of a
``torch.distributed`` group, one process per card. Counterpart of
``nbody_tpu/parallel/multihost.py``, with its names.

Usage (the same script in every process, e.g. under
``torchrun --nproc-per-node=<cards>``)::

    from nbody_tpu_torch.parallel import multihost
    multihost.initialize()                       # torchrun's variables
    scene = nt.make_galaxies(1_000_000, 3, seed=11037)  # deterministic,
    world = multihost.multihost_world(scene)            # same on all ranks
    world.update(0.01, 100)
    parts = multihost.gather_particles(world)    # the whole state, every rank

Design:
  * The scene is deterministic in its seed (numpy on the host), so every
    process builds the same host scene and the same padded host state, and
    no scene is broadcast; each process copies only its own shards' rows
    to its devices.
  * The world is a :class:`~nbody_tpu_torch.parallel.ShardedWorld` over
    the group (``from_arrays`` with ``group``): rank r holds shards
    r·L … r·L + L − 1 of D = L × the group's size. Its collectives gather
    every shard's pieces from every rank in shard order and reduce them
    the same way on each (``ops/collective.py``), so every rank holds the
    bits a single-process world of the same D holds.
  * NCCL carries CUDA shards and Gloo (``cpu_collectives``) CPU shards;
    there is no staging of CUDA tensors through Gloo and no silent switch.
  * ``ShardedWorld.particles`` and ``state`` raise on a world over more
    than one process; :func:`gather_particles` gathers the whole state to
    every rank. ``utils.checkpoint.save_world`` writes such a world on rank
    0, and the file restores on a single-process world.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..types import DEFAULT_SIM_CONFIG, Particles, SimConfig
from .sharding import ShardedWorld, make_mesh, padded_state, shard_layout

CPU_COLLECTIVES = ("gloo", "mpi")

# this process's devices as ``initialize`` chose them (None before it ran)
_LOCAL_DEVICES: list | None = None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None,
               cpu_collectives: str | None = "gloo",
               *, device: str = "cuda") -> None:
    """Join the process group (``torch.distributed.init_process_group``);
    a second call does nothing.

    With no coordinator, count or id the group comes from the environment
    (``env://``: the variables ``torchrun`` sets); otherwise from
    ``tcp://<coordinator_address>`` ("host:port") with ``num_processes``
    and ``process_id``. ``device`` is the kind of this process's shards:
    "cuda" (the default) takes NCCL and the cards ``local_device_ids``
    names, by default ``cuda:<local rank>`` (``LOCAL_RANK``, else the
    process id modulo the cards); "cpu" takes ``cpu_collectives`` and one
    CPU shard for each of ``local_device_ids`` (one by default). Without a
    card "cuda" raises, and "cpu" with no CPU backend raises: there is no
    fallback."""
    global _LOCAL_DEVICES
    if dist.is_initialized():
        return
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: no CUDA device (torch.cuda.is_available() is "
                "False); pass device='cpu' for CPU shards over Gloo")
        backend = "nccl"
    elif kind == "cpu":
        if cpu_collectives not in CPU_COLLECTIVES:
            raise ValueError(
                f"initialize: CPU shards need a CPU collective backend "
                f"{CPU_COLLECTIVES}, got cpu_collectives={cpu_collectives!r}")
        backend = cpu_collectives
    else:
        raise ValueError(f"initialize: device must be 'cuda' or 'cpu', "
                         f"got {device!r}")
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        kw = {"init_method": "env://"}
        rank = int(os.environ.get("RANK", 0))
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize: pass coordinator_address, "
                             "num_processes and process_id together, or "
                             "none of them (env://)")
        kw = {"init_method": f"tcp://{coordinator_address}",
              "world_size": num_processes, "rank": process_id}
        rank = process_id
    if kind == "cuda":
        if local_device_ids is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            local_device_ids = [local]
        devices = [torch.device("cuda", int(i)) for i in local_device_ids]
        torch.cuda.set_device(devices[0])
    else:
        devices = [torch.device("cpu")] * (
            1 if local_device_ids is None else len(local_device_ids))
    dist.init_process_group(backend, **kw)
    _LOCAL_DEVICES = devices


def local_devices() -> list:
    """This process's devices: those :func:`initialize` chose, or, where
    the group was started another way, ``cuda:<current device>`` under
    NCCL and one CPU shard otherwise."""
    if _LOCAL_DEVICES is not None:
        return list(_LOCAL_DEVICES)
    if str(dist.get_backend()).lower() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]


def multihost_world(scene: Particles, mesh: list | None = None, *,
                    config: SimConfig = DEFAULT_SIM_CONFIG,
                    force_backend=None) -> ShardedWorld:
    """A ShardedWorld over every process of the group from a scene that
    every process passes alike (e.g. the same seeded ``make_galaxies``).
    ``mesh`` is this process's devices (default :func:`local_devices`);
    every process must hold as many. Each process copies only its own
    shards' rows to its devices. Without a process group it is
    ``ShardedWorld(scene, mesh)``; a group of one gives the same world, its
    collectives run through the group."""
    if not dist.is_initialized():
        return ShardedWorld(scene, mesh, config=config,
                            force_backend=force_backend)
    devices = make_mesh(devices=local_devices() if mesh is None else mesh)
    size, rank = dist.get_world_size(), dist.get_rank()
    n = scene.pos.shape[0]
    mass_len = int(torch.count_nonzero(torch.as_tensor(scene.mass) > 0))
    _, t_loc, _, n_pad = shard_layout(n, mass_len, config,
                                      size * len(devices))
    state, _, _ = padded_state(scene, mass_len, n_pad, config.g)
    rows = slice(rank * len(devices) * t_loc, (rank + 1) * len(devices) * t_loc)
    return ShardedWorld.from_arrays(
        state.pos[rows], state.vel[rows], state.acc[rows], state.mass[rows],
        state.radius[rows], total_len=n, mass_len=mass_len, mesh=devices,
        config=config, force_backend=force_backend, group=dist.group.WORLD)


def gather_particles(world: ShardedWorld) -> Particles:
    """The whole state (the first N rows in shard order, partitioned order
    as ``ShardedWorld.particles``) as CPU tensors on every process: one
    gather of the five fields of every shard. Every process of the world's
    group must call it. A world without a group returns ``particles``."""
    if world.group.pg is None:
        return world.particles
    dev0 = world.mesh[0]
    packed = [torch.cat([p, v, a, m[:, None], r[:, None]], dim=1).to(dev0)
              for p, v, a, m, r in zip(world.pos, world.vel, world.acc,
                                       world.mass, world.radius)]
    whole = torch.cat(world.group.gather(packed, dev0))[:world.total_len]
    whole = whole.cpu()
    return Particles(pos=whole[:, 0:2].contiguous(),
                     vel=whole[:, 2:4].contiguous(),
                     acc=whole[:, 4:6].contiguous(),
                     mass=whole[:, 6].contiguous(),
                     radius=whole[:, 7].contiguous())
