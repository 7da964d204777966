"""Particle-mesh (PM) far-field gravity in plain PyTorch: O(N + G² log G).

Counterpart of ``nbody_tpu/ops/pm_forces.py``, which leaves the whole mesh
stage to XLA outside any Pallas kernel; here it is PyTorch on whatever
device the tensors are on:

  rho  = CIC(src, gm)                      (G, G) mass grid
  A_x  = conv(rho, Kx),  Kx(v) = v_x / (|v|² + eps²)^{3/2}
  acc  = CIC-gather(A_x, A_y)(targets)

The convolution is free-space (zero-padded to 2G per axis) through
``torch.fft.rfft2``/``irfft2``. The box adapts to the bounding square of the
particles at every call. ``_box`` and ``_cic_weights`` keep the JAX
package's fp32 operation order, so cell indices agree with it bit for bit.
The CIC scatter accumulates into the flattened grid with
``forces.add_at``: on the card ``index_put_(..., accumulate=True)``, which
sorts its indices and sums each cell's entries in their order, so two runs
give the same bits (``index_add_`` sums by float atomics there, in an order
that varies from run to run); on the CPU ``scatter_add_``, serially in the
same order (``index_put_`` there adds by float atomics across threads from
32768 entries on).

The sizes and shapes stay on the device: the box is a pair of 0-dim
tensors, so nothing here waits for the host.
"""

from __future__ import annotations

import torch

from ..forces import add_at
from ..types import DTYPE


def suggest_grid(n: int, lo: int = 256, hi: int = 4096) -> int:
    """Mesh resolution for ``n`` particles: the next power of two >=
    sqrt(n), clamped to [lo, hi] (about one particle per cell)."""
    g = 1
    while g * g < n:
        g <<= 1
    return max(lo, min(hi, g))


def _cic_weights(pos, lo, inv_h, grid):
    """Cloud-in-cell: lower-corner cell indices and bilinear weights of each
    point. Cell centers sit at lo + (i + 0.5) h. Returns (i0, j0, wx, wy),
    indices clamped to [0, grid - 2] as int64."""
    u = (pos[:, 0] - lo[0]) * inv_h - 0.5
    v = (pos[:, 1] - lo[1]) * inv_h - 0.5
    i0 = torch.floor(u)
    j0 = torch.floor(v)
    wx = u - i0
    wy = v - j0
    i0 = i0.to(torch.int64).clamp(0, grid - 2)
    j0 = j0.to(torch.int64).clamp(0, grid - 2)
    return i0, j0, wx, wy


def _bounds(tgt_pos, src_pos, src_gm, tgt_mask=None):
    """Bounding box (min, max), each (2,), over targets and real (gm != 0)
    sources; with ``tgt_mask`` only the rows it marks non-zero count."""
    inf = float("inf")
    src_real = (src_gm != 0.0)[:, None]
    s_min = torch.where(src_real, src_pos, inf).amin(dim=0)
    s_max = torch.where(src_real, src_pos, -inf).amax(dim=0)
    if tgt_mask is not None:
        t_real = (tgt_mask.reshape(-1) != 0.0)[:, None]
        t_min = torch.where(t_real, tgt_pos, inf).amin(dim=0)
        t_max = torch.where(t_real, tgt_pos, -inf).amax(dim=0)
    else:
        t_min = tgt_pos.amin(dim=0)
        t_max = tgt_pos.amax(dim=0)
    return torch.minimum(t_min, s_min), torch.maximum(t_max, s_max)


def _box(all_min, all_max, grid):
    """(lo (2,), h 0-dim): the square box with 2/grid margin on each side."""
    all_min = torch.where(torch.isfinite(all_min), all_min, 0.0)
    all_max = torch.where(torch.isfinite(all_max), all_max, 1.0)
    center = 0.5 * (all_min + all_max)
    half = 0.5 * (all_max - all_min).amax() * (1.0 + 4.0 / grid) + 1e-3
    lo = center - half
    h = 2.0 * half / grid
    return lo, h


def _cic_scatter(src_pos, src_gm, lo, inv_h, grid):
    """(G, G) mass grid: each source's gm spread over its four CIC cells.
    Each cell sums its entries in a fixed order: the four corners in the
    JAX package's order, each corner's sources in row order."""
    i0, j0, wx, wy = _cic_weights(src_pos, lo, inv_h, grid)
    c = i0 * grid + j0
    cells = torch.cat([c, c + grid, c + 1, c + grid + 1])
    mass = torch.cat([src_gm * ((1 - wx) * (1 - wy)), src_gm * (wx * (1 - wy)),
                      src_gm * ((1 - wx) * wy), src_gm * (wx * wy)])
    rho = torch.zeros(grid * grid, dtype=DTYPE, device=src_pos.device)
    add_at(rho, cells, mass)
    return rho.reshape(grid, grid)


def _solve(rho, h, eps2, grid, rc=None):
    """Free-space convolution of the mass grid with the softened 1/r²
    kernel: the stacked (G, G, 2) force grid. With ``rc`` the kernel is
    multiplied by the P³M smootherstep taper g(r/rc)."""
    n2 = 2 * grid
    idx = torch.arange(n2, device=rho.device)
    d = torch.where(idx < grid, idx, idx - n2).to(DTYPE)  # wraparound order
    dx = d[:, None] * h
    dy = d[None, :] * h
    dist2 = dx * dx + dy * dy
    r2 = dist2 + eps2
    inv_r3 = torch.rsqrt(r2) / r2
    # the zero-displacement sample: with eps = 0 it is 0*inf -> NaN
    inv_r3 = torch.where(r2 > 0.0, inv_r3, 0.0)
    if rc is not None:
        from .p3m_forces import _taper

        inv_r3 = inv_r3 * _taper(dist2, rc)
    kx = dx * inv_r3
    ky = dy * inv_r3
    rho_pad = torch.zeros((n2, n2), dtype=DTYPE, device=rho.device)
    rho_pad[:grid, :grid] = rho
    f_rho = torch.fft.rfft2(rho_pad)
    # A(c) = sum_{c'} rho(c') K(c' - c): a correlation; K is odd, so it is
    # minus the convolution.
    ax = -torch.fft.irfft2(f_rho * torch.fft.rfft2(kx), s=(n2, n2))
    ay = -torch.fft.irfft2(f_rho * torch.fft.rfft2(ky), s=(n2, n2))
    return torch.stack([ax[:grid, :grid], ay[:grid, :grid]], dim=-1)


def _cic_gather(a_grid, tgt_pos, lo, inv_h, grid):
    """Bilinear gather of the (G, G, 2) force grid at each target: (T, 2),
    the four corners summed in the JAX package's order."""
    i0, j0, wx, wy = _cic_weights(tgt_pos, lo, inv_h, grid)
    flat = a_grid.reshape(grid * grid, 2)
    c = i0 * grid + j0
    out = flat[c] * ((1 - wx) * (1 - wy))[:, None]
    out = out + flat[c + grid] * (wx * (1 - wy))[:, None]
    out = out + flat[c + 1] * ((1 - wx) * wy)[:, None]
    return out + flat[c + grid + 1] * (wx * wy)[:, None]


def pm_acc(
    tgt_pos: torch.Tensor,   # (T, 2)
    src_pos: torch.Tensor,   # (S, 2)
    src_gm: torch.Tensor,    # (S,) G * mass (zero rows are inert)
    softening: float = 2.0,
    *,
    grid: int = 512,
    tgt_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Far-field accelerations (T, 2) on targets from sources by
    particle-mesh, with one global Plummer ``softening`` (the counterpart of
    ``nbody_tpu.ops.pm_forces.pm_acc``). ``tgt_mask`` (optional, (T,) or
    (T, 1), 0/1) keeps padding rows out of the box. ``softening`` may be a
    float or a 0-dim tensor on the device."""
    eps2 = torch.as_tensor(softening, dtype=DTYPE, device=src_pos.device) ** 2
    all_min, all_max = _bounds(tgt_pos, src_pos, src_gm, tgt_mask)
    lo, h = _box(all_min, all_max, grid)
    rho = _cic_scatter(src_pos, src_gm, lo, 1.0 / h, grid)
    a_grid = _solve(rho, h, eps2, grid)
    return _cic_gather(a_grid, tgt_pos, lo, 1.0 / h, grid)
