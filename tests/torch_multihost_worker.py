"""Subprocess worker for tests/test_torch_multihost.py.

One of N cooperating processes (argv: proc_id nprocs port outdir), each
with 4 CPU shards, joined over Gloo into one world of 4N shards: the CPU
stand-in for one process per card under NCCL. For each of the backends
"torch", "cuda_ring" (its plain versions on CPU shards), "pm" and "p3m" it
runs 10 substeps and an adaptive span, gathers the whole state, writes an
npz checkpoint (rank 0) and a shard-native one (every rank its own
shards), restores its own shards from the latter over the group, runs 2
more substeps on the live and the restored world, and writes its results.
Imports neither JAX nor nbody_tpu.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Must mirror tests/test_torch_multihost.py.
N, GALAXIES, SEED, DT, SUBSTEPS = 1536, 2, 7, 0.005, 10
SPAN, DT_MAX = 0.01, 0.005
LOCAL = 4
BACKENDS = ("torch", "cuda_ring", "pm", "p3m")
FIELDS = ("pos", "vel", "acc", "mass", "radius")
RESUMED = 2                     # substeps on the live and restored worlds
# the mesh cut to CPU size, as tests/test_torch_sharded_mesh.py cuts it
CONFIG = dict(pm_grid=256, p3m_cell_capacity=32)
THREADS = 2


def _resumed_equal(world, restored, fields) -> bool:
    """RESUMED more substeps on both: this rank's shards bit-equal."""
    import torch

    world.update(DT, RESUMED)
    restored.update(DT, RESUMED)
    return all(torch.equal(a, b) for f in fields for a, b in
               zip(getattr(restored, f), getattr(world, f)))


def main() -> None:
    proc_id, nprocs = int(sys.argv[1]), int(sys.argv[2])
    port, outdir = sys.argv[3], sys.argv[4]

    import numpy as np
    import torch

    torch.set_num_threads(THREADS)
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.parallel import multihost
    from nbody_tpu_torch.utils.checkpoint import (load_sharded_world_dcp,
                                                  save_world, save_world_dcp)

    for _ in range(2):  # the second call does nothing
        multihost.initialize(f"localhost:{port}", nprocs, proc_id,
                             local_device_ids=range(LOCAL), device="cpu")
    import torch.distributed as dist

    assert dist.get_world_size() == nprocs and dist.get_rank() == proc_id
    assert multihost.local_devices() == [torch.device("cpu")] * LOCAL

    # deterministic in the seed: the same scene on every process
    scene = nt.make_galaxies(N, GALAXIES, seed=SEED)
    for backend in BACKENDS:
        world = multihost.multihost_world(
            scene, config=nt.SimConfig(**CONFIG), force_backend=backend)
        assert world.n_devices == LOCAL * nprocs
        assert world.first == LOCAL * proc_id
        world.update(DT, SUBSTEPS)
        fixed = multihost.gather_particles(world)
        k_adaptive = world.update_adaptive(SPAN, dt_max=DT_MAX)
        parts = multihost.gather_particles(world)
        save_world(f"{outdir}/{backend}_ckpt.npz", world,
                   step=SUBSTEPS + k_adaptive)
        save_world_dcp(f"{outdir}/{backend}_dcp", world,
                       step=SUBSTEPS + k_adaptive)
        restored, step = load_sharded_world_dcp(
            f"{outdir}/{backend}_dcp", world.mesh, force_backend=backend,
            group=dist.group.WORLD)
        dcp_equal = [step == SUBSTEPS + k_adaptive,
                     restored.first == world.first,
                     restored.config == world.config]
        dcp_equal += [torch.equal(a, b) for f in FIELDS for a, b in
                      zip(getattr(restored, f), getattr(world, f))]
        try:
            world.particles
            refused = False
        except RuntimeError:
            refused = True
        gm_src = world.gm_src.numpy()
        resumed = _resumed_equal(world, restored, FIELDS)
        np.savez(f"{outdir}/proc{proc_id}_{backend}.npz",
                 **{f: getattr(parts, f).numpy() for f in FIELDS},
                 **{f"{f}_fixed": getattr(fixed, f).numpy()
                    for f in ("pos", "vel", "acc", "mass")},
                 k_adaptive=np.int64(k_adaptive),
                 particles_refused=np.bool_(refused),
                 gm_src=gm_src, dcp_equal=np.array(dcp_equal),
                 dcp_resumed_equal=np.bool_(resumed))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
