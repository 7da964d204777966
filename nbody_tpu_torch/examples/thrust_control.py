"""Differentiable CONTROL: optimize a piecewise-constant thrust schedule
so a probe, launched at rest, reaches a target through a three-body field:
gradients flow through ``autodiff.rollout``'s extra_force hook into the
control parameters (``extra_force_params``), not just the initial state
(compare the shooting example, which optimizes the launch velocity).

The schedule is K constant-thrust segments, realized as K chained
rollouts in one loss; each segment's thrust vector is a row of the
differentiated parameter tensor, reached through
``extra_force(pos, vel, theta)``. A soft fuel penalty keeps the schedule
physical.

Usage: python -m nbody_tpu_torch.examples.thrust_control [iters]
       [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from nbody_tpu_torch.autodiff import rollout
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.types import DTYPE

SEGMENTS, STEPS_PER_SEG, DT = 4, 50, 0.02
PROBE = 3


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    iters = int(argv[0]) if len(argv) > 0 else 150

    def t(x):
        return torch.tensor(x, dtype=DTYPE, device=device)

    # three suns + one massless probe (index 3), launched AT REST: only the
    # thrust schedule can steer it
    pos0 = t([[0.0, 0.0], [300.0, 100.0], [150.0, -200.0], [-200.0, 0.0]])
    vel0 = torch.zeros((4, 2), dtype=DTYPE, device=device)
    mass = t([1e6, 5e5, 8e5, 0.0])
    radius = t([5.0, 4.0, 4.0, 0.5])
    target = t([400.0, -100.0])
    probe = (torch.arange(4, device=device) == PROBE).to(DTYPE)[:, None]
    backend = "cuda" if device.type == "cuda" else "torch"

    def thrust(p, v, theta):
        # accelerate only the probe (row PROBE) by the segment's thrust
        return probe * theta

    def loss_and_grad(schedule):            # (SEGMENTS, 2)
        schedule = schedule.detach().requires_grad_()
        p, v = pos0, vel0
        for k in range(SEGMENTS):
            p, v = rollout(p, v, mass, radius, DT, n_steps=STEPS_PER_SEG,
                           mass_len=3, backend=backend, extra_force=thrust,
                           extra_force_params=schedule[k])
        # fuel cost keeps the schedule physical (soft penalty)
        loss = (torch.sum((p[PROBE] - target) ** 2)
                + 1.0 * torch.sum(schedule ** 2))
        grad, = torch.autograd.grad(loss, schedule)
        return loss.detach(), grad

    schedule = torch.zeros((SEGMENTS, 2), dtype=DTYPE, device=device)
    l, _ = loss_and_grad(schedule)
    for k in range(iters):
        l, g = loss_and_grad(schedule)
        schedule = schedule - 5e-4 * g
        if k % 25 == 0:
            print(f"iter {k:4d}  miss ~{float(torch.sqrt(l)):10.2f}")
    final_miss = float(torch.sqrt(torch.clamp(
        l - 1.0 * torch.sum(schedule ** 2), min=0.0)))
    print(f"final miss distance: {final_miss:.2f}")
    print("thrust schedule (ax, ay per segment):")
    print(schedule.cpu().numpy())
    return {"l": l, "schedule": schedule, "final_miss": final_miss}


if __name__ == "__main__":
    globals().update(main())
