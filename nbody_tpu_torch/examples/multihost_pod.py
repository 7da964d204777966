"""Multi-process run: one simulation spanning every process's cards.

Launch the SAME script in every process, one process a card, e.g. with
torchrun on each host:

    torchrun --nnodes=<hosts> --nproc-per-node=<cards> ... \
        -m nbody_tpu_torch.examples.multihost_pod 1000000 --distributed

With --distributed, ``multihost.initialize()`` joins the process group
from torchrun's variables (NCCL, ``cuda:<LOCAL_RANK>``); other launchers
pass the coordinator, count and rank themselves (see
nbody_tpu_torch/parallel/multihost.py). Without the flag this is a single
process over its local cards, so the script runs standalone, and
--cpu-demo gives 8 CPU shards (over Gloo with --distributed).

Usage: python -m nbody_tpu_torch.examples.multihost_pod [n_particles]
       [--cpu-demo] [--distributed] [--device cpu]
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device, take_flag
from nbody_tpu_torch.parallel import multihost


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu_demo = take_flag(argv, "--cpu-demo")
    distributed = take_flag(argv, "--distributed")
    device = take_device(argv, "cpu" if cpu_demo else "cuda")
    mesh = None                           # this process's cards
    if distributed:
        multihost.initialize(local_device_ids=range(8) if cpu_demo else None,
                             device=device.type)
    elif cpu_demo:
        mesh = ["cpu"] * 8
    elif device.type == "cpu":
        mesh = ["cpu"]

    n = int(argv[0]) if len(argv) > 0 else 4096
    # Seeded host-side synthesis: every process builds the identical scene,
    # so nothing is broadcast; each copies only its own shards' rows.
    scene = nt.make_galaxies(n, 2, seed=11037)
    world = multihost.multihost_world(scene, mesh)
    rank, size = ((dist.get_rank(), dist.get_world_size())
                  if dist.is_initialized() else (0, 1))
    print(f"process {rank}/{size}: {len(world.mesh)} local of "
          f"{world.n_devices} global devices; N={world.total_len} "
          f"targets/device={world.t_loc}")

    world.update(0.01, 100)

    # The whole state on every process (ShardedWorld.particles refuses a
    # world over several processes).
    parts = multihost.gather_particles(world)
    p = (parts.mass[:, None] * parts.vel).sum(dim=0)
    print(f"after 100 substeps: finite={bool(torch.isfinite(parts.pos).all())} "
          f"momentum=({float(p[0]):.3e}, {float(p[1]):.3e})")
    if distributed:
        dist.destroy_process_group()
    return {"world": world, "parts": parts}


if __name__ == "__main__":
    globals().update(main())
