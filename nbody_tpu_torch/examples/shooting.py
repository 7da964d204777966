"""Differentiable shooting problem: optimize a probe's launch velocity so
it arrives at a target after flying through a three-body gravitational
field: gradient descent straight through the simulator
(nbody_tpu_torch.autodiff; on the card the force's backward is the
hand-written kernel csrc/direct_vjp.cu).

Usage: python -m nbody_tpu_torch.examples.shooting [iters] [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from nbody_tpu_torch.autodiff import rollout
from nbody_tpu_torch.examples import take_device
from nbody_tpu_torch.types import DTYPE

N_STEPS, DT = 200, 0.02


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = take_device(argv)
    iters = int(argv[0]) if len(argv) > 0 else 200

    def t(x):
        return torch.tensor(x, dtype=DTYPE, device=device)

    # three suns + one massless probe (index 3)
    pos = t([[0.0, 0.0], [300.0, 100.0], [150.0, -200.0], [-200.0, 0.0]])
    vel = torch.zeros((4, 2), dtype=DTYPE, device=device)
    mass = t([1e6, 5e5, 8e5, 0.0])
    radius = t([5.0, 4.0, 4.0, 0.5])
    target = t([400.0, -100.0])
    backend = "cuda" if device.type == "cuda" else "torch"

    def loss_and_grad(v0):
        v0 = v0.detach().requires_grad_()
        v = torch.cat([vel[:3], v0[None]])
        p, _ = rollout(pos, v, mass, radius, DT, n_steps=N_STEPS, mass_len=3,
                       backend=backend)
        loss = torch.sum((p[3] - target) ** 2)
        grad, = torch.autograd.grad(loss, v0)
        return loss.detach(), grad

    v0 = t([10.0, 0.0])
    l, _ = loss_and_grad(v0)  # also defines l for the final print at iters=0
    for k in range(iters):
        l, g = loss_and_grad(v0)
        v0 = v0 - 1e-3 * g
        if k % 25 == 0:
            print(f"iter {k:4d}  miss distance {float(torch.sqrt(l)):10.3f}  "
                  f"v0 = {v0.cpu().numpy()}")
    print(f"final miss distance: {float(torch.sqrt(l)):.3f} "
          f"(launch velocity {v0.cpu().numpy()})")
    return {"l": l, "v0": v0}


if __name__ == "__main__":
    globals().update(main())
