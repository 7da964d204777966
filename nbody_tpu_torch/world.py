"""World: particle state on one device, the backend switch and the substep
loop. Counterpart of ``nbody_tpu/world.py`` for the direct-sum path.

  * Creation partitions particles massive-first with a stable sort
    (world.c:33-46; the same order as ``nbody_tpu``), moves them to the
    device named by the caller, and forms ``gm = g * mass[:mass_len]``.
    State has exactly N rows: the CUDA kernel masks its own ragged edges,
    so no target or source padding is needed.
  * ``update(dt, n)`` is a Python loop of n substeps. On the "cuda" backend
    each substep (each DKD stage for leapfrog/yoshida4) is one launch of
    the fused force-and-integrate kernel; "torch" is the plain PyTorch
    version. The loop never syncs with the host: ``dt`` stays a Python
    float, and only ``particles`` and ``block_until_ready`` wait.
  * Jacobi substeps: every launch reads (pos, vel) and writes new buffers,
    and the World swaps them in, as the reference double-buffers its
    storage (sim_gpu.c:19). PyTorch's caching allocator hands the freed
    pair back to the next launch.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from . import forces, integrators
from .ops.direct_forces import fused_substep
from .types import (DEFAULT_SIM_CONFIG, DTYPE, Particles, SimConfig,
                    astuple_shallow)

Backend = Literal["torch", "cuda"]
BACKENDS = ("torch", "cuda")


def partition_massive_first(mass) -> tuple[torch.Tensor, int]:
    """Return (permutation, mass_len): indices reordering particles so all
    with mass > 0 come first (world.c:33-46). Stable within each group."""
    mass = torch.as_tensor(mass)
    order = torch.argsort((mass <= 0).to(torch.int8), stable=True)
    mass_len = int(torch.count_nonzero(mass > 0))
    return order, mass_len


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device}")
    return device


class World:
    """Stateful wrapper mirroring the reference World ergonomics
    (nbody.h:61-73): create, update, read back."""

    def __init__(self, particles: Particles, *, config: SimConfig = DEFAULT_SIM_CONFIG,
                 device: torch.device | str):
        self.device = _resolve_device(device)
        order, mass_len = partition_massive_first(particles.mass)

        def put(x):
            x = torch.as_tensor(x, dtype=DTYPE)
            return x[order.to(x.device)].to(self.device).contiguous()

        self.state = Particles(
            pos=put(particles.pos), vel=put(particles.vel),
            acc=put(particles.acc), mass=put(particles.mass),
            radius=put(particles.radius))
        self.gm = (config.g * self.state.mass[:mass_len]).contiguous()
        self.total_len = self.state.n
        self.mass_len = mass_len
        self.config = config
        self.default_backend: Backend = (
            "cuda" if self.device.type == "cuda" else "torch")
        self._host_cache: Particles | None = None

    # -- update ---------------------------------------------------------
    def update(self, dt: float, n: int = 1, backend: Backend | None = None) -> "World":
        """n substeps of size dt on ``backend`` (default: "cuda" on a CUDA
        device, "torch" on the CPU)."""
        backend = backend or self.default_backend
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend 'cuda' needs a world on a CUDA device, this one is "
                f"on {self.device}")
        if n <= 0:
            return self
        step = self._step_cuda if backend == "cuda" else self._step_torch
        for _ in range(n):
            step(float(dt))
        self._host_cache = None
        return self

    def _step_cuda(self, dt: float) -> None:
        st = self.state
        ws = integrators.stage_weights(self.config.integrator)
        pos, vel, acc = st.pos, st.vel, st.acc
        for w in (1.0,) if ws is None else ws:
            # the stage dt rounded in fp32, as the JAX step forms it
            dtk = dt if w == 1.0 else float(np.float32(w) * np.float32(dt))
            pos_in = pos if ws is None else pos + (0.5 * dtk) * vel
            pos, vel, acc = fused_substep(
                dtk, pos_in, vel, st.radius, self.gm,
                precise=self.config.precise,
                pos_dt=1.0 if ws is None else 0.5)
        self.state = Particles(pos=pos, vel=vel, acc=acc, mass=st.mass,
                               radius=st.radius)

    def _step_torch(self, dt: float) -> None:
        st = self.state

        def force_at(p):
            return forces.direct_sum_acc(p, st.radius, p[:self.mass_len],
                                         self.gm, precise=self.config.precise)

        pos, vel, acc = integrators.advance(
            self.config.integrator, force_at, st.pos, st.vel, dt)
        self.state = Particles(pos=pos, vel=vel, acc=acc, mass=st.mass,
                               radius=st.radius)

    # Reference API names (nbody.h:69-73): "CPU" = the plain PyTorch
    # version, "GPU" = the CUDA kernel.
    def update_cpu(self, dt: float, n: int = 1) -> "World":
        return self.update(dt, n, backend="torch")

    def update_gpu(self, dt: float, n: int = 1) -> "World":
        return self.update(dt, n, backend="cuda")

    # -- read back -------------------------------------------------------
    @property
    def particles(self) -> Particles:
        """Freshest state as CPU tensors, in partitioned order
        (GetWorldParticles, world.c:91-97). Cached until the next update."""
        if self._host_cache is None:
            self._host_cache = Particles(
                *(x.to("cpu", copy=True) for x in astuple_shallow(self.state)))
        return self._host_cache

    def block_until_ready(self) -> "World":
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def __len__(self) -> int:
        return self.total_len


def create_world(particles: Particles, *, config: SimConfig = DEFAULT_SIM_CONFIG,
                 device: torch.device | str) -> World:
    """CreateWorld (nbody.h:61) on ``device`` ("cpu" or "cuda[:k]")."""
    return World(particles, config=config, device=device)
