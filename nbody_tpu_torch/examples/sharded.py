"""Multi-device run: particles sharded over every card with the ring of
source tiles, on-device trajectory capture, and the shard-native
checkpoint. Pass --cpu-demo to run on 8 CPU shards instead.

Usage: python -m nbody_tpu_torch.examples.sharded [n_particles]
       [--cpu-demo] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.diagnostics import summary
from nbody_tpu_torch.examples import take_device, take_flag
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.utils.checkpoint import (load_sharded_world_dcp,
                                              save_world_dcp)


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    # --cpu-demo: 8 CPU shards, for a machine without cards
    cpu_demo = take_flag(argv, "--cpu-demo")
    device = take_device(argv, "cpu" if cpu_demo else "cuda")
    n = int(argv[0]) if len(argv) > 0 else 4096
    if cpu_demo:
        mesh = make_mesh(devices=["cpu"] * 8)
    else:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(
            devices=[device])
    print(f"mesh: {len(mesh)} x {mesh[0].type}")

    scene = nt.make_galaxies(n, 2, seed=11037)
    sw = ShardedWorld(scene, mesh)
    print(f"N={sw.total_len} shards={sw.n_devices} targets/device={sw.t_loc} "
          f"sources/device={sw.s_loc} force={sw.force_backend}")

    sw.update(0.01, 100)
    host = sw.particles
    print("after 100 substeps: finite =", bool(torch.isfinite(host.pos).all()))
    print("momentum:", summary(sw)["momentum"])

    # on-device capture and the shard-native checkpoint
    traj = sw.record(0.01, frames=5, steps_per_frame=4)
    print(f"captured {traj.shape} frames (single device->host gather)")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt")
        save_world_dcp(path, sw, step=120)  # each shard written from its device
        sw2, step = load_sharded_world_dcp(path, mesh,
                                           force_backend=sw.force_backend)
        print(f"restored at step {step}: each device read only its own "
              f"shard; sharding preserved = "
              f"{[x.device for x in sw2.pos] == [x.device for x in sw.pos]}")
    return {"mesh": mesh, "sw": sw, "traj": traj, "sw2": sw2, "step": step}


if __name__ == "__main__":
    globals().update(main())
