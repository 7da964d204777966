"""Carry particle state between the JAX package and the port as numpy.

Duck-typed on purpose: nothing here imports ``nbody_tpu``. Anything with the
five fields as numpy-convertible values can come in, e.g.::

    p = particles_from_numpy(**vars(jax_world.particles), device="cuda")
    with np.load("state.npz") as d:  # nbody_tpu/utils/checkpoint.py
        p = particles_from_numpy(*(d[k] for k in FIELDS), device="cpu")

and ``nbody_tpu.make_particles(**to_numpy(p))`` goes back.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import DTYPE, Particles, astuple_shallow, make_particles

FIELDS = ("pos", "vel", "acc", "mass", "radius")


def particles_from_numpy(pos, vel, acc, mass, radius, *,
                         device: torch.device | str) -> Particles:
    """Particles of fp32 tensors on ``device`` from five array-likes (copied:
    the tensors never share memory with the inputs)."""
    p = make_particles(*(np.array(x, np.float32) for x in (pos, vel, mass, radius, acc)))
    return p.to(torch.device(device))


def to_numpy(particles: Particles) -> dict[str, np.ndarray]:
    """The five fields as float32 numpy arrays on the host (copies), keyed
    by name."""
    return {name: x.detach().to("cpu", DTYPE, copy=True).numpy()
            for name, x in zip(FIELDS, astuple_shallow(particles))}
