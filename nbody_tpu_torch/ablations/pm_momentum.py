"""Why the "pm" solve runs in float64: the momentum of
tests/test_physics_validation.py:110's case (one galaxy, N=1024, seed
11037, grid 128, softening 2, dt 0.005) under three forms of the mesh
solve, on the CPU and on the card:

    python -m nbody_tpu_torch.ablations.pm_momentum [substeps] [chunks]

"fp32" is the convolution in fp32 (the solve before the repair), "odd"
the same with each kernel's spectrum made purely imaginary (the odd
kernel's exact symmetry), "float64" the shipped solve
(``ops/pm_forces._solve``). Each run starts from the same world and
prints |dp|/scale after every ``substeps`` (default 250) for ``chunks``
chunks (default 8), then the net force sum m·a over sum |m·a| of the
first state. Without a CUDA device it raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import nbody_tpu_torch as nt
from nbody_tpu_torch.ops import pm_forces as pm
from nbody_tpu_torch.scripts import validate_physics as vp
from nbody_tpu_torch.types import DTYPE

from ._scene import require_cuda


def solve_fp32(rho, h, eps2, grid, rc=None, odd=False):
    """The free-space convolution in fp32; with ``odd`` each kernel's
    spectrum keeps its imaginary part alone."""
    n2 = 2 * grid
    idx = torch.arange(n2, device=rho.device)
    d = torch.where(idx < grid, idx, idx - n2).to(DTYPE)
    dx, dy = d[:, None] * h, d[None, :] * h
    r2 = dx * dx + dy * dy + eps2
    inv_r3 = torch.where(r2 > 0.0, torch.rsqrt(r2) / r2, 0.0)
    rho_pad = torch.zeros((n2, n2), dtype=DTYPE, device=rho.device)
    rho_pad[:grid, :grid] = rho
    f_rho = torch.fft.rfft2(rho_pad)
    out = []
    for k in (dx * inv_r3, dy * inv_r3):
        kh = torch.fft.rfft2(k)
        if odd:
            kh = torch.complex(torch.zeros_like(kh.imag), kh.imag)
        out.append(-torch.fft.irfft2(f_rho * kh, s=(n2, n2))[:grid, :grid])
    return torch.stack(out, dim=-1)


SOLVES = {"fp32": solve_fp32,
          "odd": lambda *a, **k: solve_fp32(*a, **k, odd=True),
          "float64": pm._solve}


def run(device, name: str, substeps: int, chunks: int) -> dict:
    case = vp.HORIZON_CASES["pm"]
    shipped = pm._solve
    pm._solve = SOLVES[name]
    try:
        scene, world = vp.horizon_world("pm", device)
        st = world.state
        acc = nt.pm_acc(st.pos, st.pos[:world.mass_len], world.gm,
                        case["config"].pm_softening,
                        grid=case["config"].pm_grid)
        ma = st.mass.double()[:, None] * acc.double()
        net = (ma.sum(0) / ma.abs().sum()).cpu().numpy()
        r = vp.invariants(world, scene, device, chunks=chunks,
                          substeps=substeps)
    finally:
        pm._solve = shipped
    return {"dp": r["dp"], "net": net.tolist()}


def main(argv: list | None = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    card = require_cuda()
    substeps = int(argv[0]) if len(argv) > 0 else 250
    chunks = int(argv[1]) if len(argv) > 1 else 8
    out = {}
    for device in (torch.device("cpu"), card):
        for name in SOLVES:
            r = out[(device.type, name)] = run(device, name, substeps, chunks)
            print(f"{device.type:4s} {name:7s} |dp|/scale every {substeps}: "
                  + " ".join(f"{x:.3e}" for x in r["dp"])
                  + f"; net force {np.round(r['net'], 6).tolist()}",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
