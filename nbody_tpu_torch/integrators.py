"""Symplectic integrator compositions shared by every execution path.

The reference integrates with semi-implicit Euler only (``sim_cpu.c:192-193``,
``particle_cs.glsl:51-52``). This module adds higher-order symplectic schemes
as *compositions of the same drift-kick-drift (DKD) stage*, so every backend
(jnp / pallas / ring / pm / p3m, single-chip or sharded) gains them by looping
its existing position-Verlet stage over ``stage_weights`` — no new kernel code
and no carried integrator state beyond (pos, vel).

- ``"euler"``    — the reference's semi-implicit Euler (1st order), kept
  bit-exact as the default.
- ``"leapfrog"`` — one DKD stage: 2nd-order symplectic, 1 force
  evaluation/substep.
- ``"yoshida4"`` — Yoshida's 4th-order composition (H. Yoshida, *Construction
  of higher order symplectic integrators*, Phys. Lett. A 150 (1990) 262):
  three DKD stages with weights ``(w1, w0, w1)``, ``w1 = 1/(2 - 2^(1/3))``,
  ``w0 = 1 - 2*w1`` (the middle stage runs *backward*). 3 force
  evaluations/substep, 4th-order energy behaviour — the accuracy-per-force-eval
  choice for long-horizon orbits.

A copy of ``nbody_tpu/integrators.py``, which holds no JAX code. In the
port the stage loop runs eagerly: each DKD stage is one pre-drift pass plus
one launch of the fused force-and-integrate kernel (``world.py``), or the
plain force and update passes on the "torch" backend.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

INTEGRATORS = ("euler", "leapfrog", "yoshida4")

_CBRT2 = 2.0 ** (1.0 / 3.0)
YOSHIDA4_W1 = 1.0 / (2.0 - _CBRT2)          # ~ 1.3512071919596578
YOSHIDA4_W0 = 1.0 - 2.0 * YOSHIDA4_W1       # ~ -1.7024143839193153


def stage_weights(integrator: str) -> tuple[float, ...] | None:
    """DKD stage weights for ``integrator``, or None for semi-implicit Euler
    (which is not a DKD composition — callers keep their reference-exact
    Euler path when this returns None)."""
    if integrator == "euler":
        return None
    if integrator == "leapfrog":
        return (1.0,)
    if integrator == "yoshida4":
        return (YOSHIDA4_W1, YOSHIDA4_W0, YOSHIDA4_W1)
    raise ValueError(
        f"integrator must be one of {INTEGRATORS}, got {integrator!r}")


def stage_dt(w: float, dt: float) -> float:
    """The stage's dt, ``w * dt`` rounded in fp32 as the JAX step forms it
    (``w`` is weakly typed there, ``dt`` an fp32 array); ``dt`` itself for
    a weight of 1."""
    return dt if w == 1.0 else float(np.float32(w) * np.float32(dt))


def advance(
    integrator: str,
    force: Callable,
    pos,
    vel,
    dt,
):
    """Advance (pos, vel) by one substep of ``integrator``.

    ``force(pos) -> acc`` must be a pure closure over everything else
    (masses, radii, masks, frozen p3m bins, collectives...). Returns
    ``(pos, vel, acc)`` where ``acc`` is the last evaluated acceleration
    (the carried diagnostic value, matching the reference's stored ``acc``).

    The Euler branch reproduces the reference ordering bit-for-bit
    (``v += a*dt; x += v*dt``); each DKD stage is
    ``x += v*dt/2; v += a(x)*dt; x += v*dt/2`` with the stage's scaled dt.
    """
    ws = stage_weights(integrator)
    if ws is None:
        acc = force(pos)
        vel = vel + dt * acc
        pos = pos + dt * vel
        return pos, vel, acc
    for w in ws:
        dtk = stage_dt(w, dt)
        pos = pos + (0.5 * dtk) * vel
        acc = force(pos)
        vel = vel + dtk * acc
        pos = pos + (0.5 * dtk) * vel
    return pos, vel, acc
