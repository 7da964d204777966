"""Checkpoint / resume round trip + trajectory export.

Usage: python -m nbody_tpu_torch.examples.checkpoint_resume [n] [steps]
       [ckpt.npz] [traj.npz] [--device cpu]
(default paths in the temporary directory)
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

import nbody_tpu_torch as nt
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.trajectory import record_trajectory, save_trajectory
from nbody_tpu_torch.utils import load_world, save_world


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    n = int(argv[0]) if len(argv) > 0 else 2000
    steps = int(argv[1]) if len(argv) > 1 else 500
    ckpt_path = (argv[2] if len(argv) > 2 else
                 os.path.join(tempfile.gettempdir(), "nbody_ckpt.npz"))
    traj_path = (argv[3] if len(argv) > 3 else
                 os.path.join(tempfile.gettempdir(), "nbody_traj.npz"))

    scene = nt.make_galaxies(n, 2, seed=7)
    world = nt.create_world(scene, device=device)

    world.update(0.01, steps)
    save_world(ckpt_path, world, step=steps)
    print(f"checkpointed at step {steps}")

    resumed, step = load_world(ckpt_path, device=device)
    print(f"resumed at step {step}; mass_len={resumed.mass_len}")

    frames = min(50, steps)
    traj = record_trajectory(resumed, 0.01, frames=frames, steps_per_frame=10)
    save_trajectory(traj_path, traj, dt=np.float32(0.01))
    print(f"recorded {traj.shape} trajectory "
          f"({frames} frames x 10 substeps, one device pass)")
    return {"world": world, "resumed": resumed, "step": step, "traj": traj}


if __name__ == "__main__":
    globals().update(main())
