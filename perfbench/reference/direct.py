"""Reference of the exact direct sum: every row pulled by every massive
row (the sources are the first ``len(gm)`` rows), stepped by semi-implicit
Euler."""

from __future__ import annotations

import torch

from . import common


def acc(pos, radius, gm, cfg: dict, dtype=torch.float64):
    """(N, 2) accelerations at ``pos`` in ``dtype``."""
    return common.direct_acc(pos, radius, pos[:gm.shape[0]], gm, dtype)


def step(cfg: dict, ref: dict, pos, vel, dtype=torch.float64) -> dict:
    """One substep from (pos, vel): {acc, vel, pos} in ``dtype``."""
    return common.euler_step(acc, cfg, ref, pos, vel, dtype)


def update_parts(cfg: dict, pos, vel, got: dict) -> dict:
    """The update the program's own force and velocity give, as
    {field: (base, increment)}."""
    return common.euler_parts(cfg, pos, vel, got)
