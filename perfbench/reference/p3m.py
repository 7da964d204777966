"""Reference of the P³M solver (Hockney & Eastwood's particle-particle
particle-mesh), with the semantics the configuration states:

  acc = mesh(tapered kernel) + pairs(exact − tapered, d < rc) ;
  the ``exact_targets`` largest-radius rows get the direct sum instead.

* Box: the square around every row, a margin of 2/grid on each side plus
  1e-3; grid cells of size h; P³M cells of size grid·h/gc ≥ rc, gc =
  grid // rc_cells, rc = rc_cells·h.
* Mesh: each massive row's g·m spread over its four cloud-in-cell cells,
  a free-space (zero-padded) convolution with K(d) = d·(d² + eps²)^(-3/2)
  times the smootherstep taper g(d/rc) = u³(10 − 15u + 6u²), u = min(d/rc,
  1), and the field read back at each row by the same four weights.
* Pairs: a cell keeps its first ``cell_capacity`` sources heaviest first
  (ties in row order) and its first ``cell_capacity`` targets in row
  order; each kept target meets the kept sources of its 3×3 neighbour
  cells, and a pair closer than rc adds g·m·(r2^(-3/2) − g(d/rc)·(d² +
  eps²)^(-3/2))·(x_s − x_t), r2 = d² + radius_t. A target past its
  cell's capacity keeps the mesh force alone.
* Step: semi-implicit Euler, as the configuration's integrator states.

The discrete choices (the box, h, each row's cells and cloud-in-cell
weights) are formed in float32, as the configuration defines them, so that
a row on a cell boundary falls on the same side as in the program; the
physics is summed in ``dtype``.
"""

from __future__ import annotations

import torch

from . import common
from .common import SOFTENING_FLOOR, direct_acc

# Candidate pairs of one block of the pair sum: 2**24 pairs hold about
# 2 GiB of float64 and int64 temporaries.
PAIR_CHUNK = 1 << 24


def box(pos, grid: int):
    """(lo (2,), h 0-dim), float32: the square around ``pos``."""
    all_min, all_max = pos.amin(dim=0), pos.amax(dim=0)
    center = 0.5 * (all_min + all_max)
    half = 0.5 * (all_max - all_min).amax() * (1.0 + 4.0 / grid) + 1e-3
    return center - half, 2.0 * half / grid


def cells(pos, lo, h, grid: int, rc_cells: int):
    """(flat P³M cell of each row, gc): float32 cell arithmetic."""
    gc = max(grid // rc_cells, 1)
    inv_c = 1.0 / ((grid * h) / gc)
    ij = torch.floor((pos - lo) * inv_c).to(torch.int64).clamp(0, gc - 1)
    return ij[:, 0] * gc + ij[:, 1], gc


def cic(pos, lo, h, grid: int):
    """Lower-corner mesh cell (i, j) of each row and its float32 weights."""
    inv_h = 1.0 / h
    u = (pos[:, 0] - lo[0]) * inv_h - 0.5
    v = (pos[:, 1] - lo[1]) * inv_h - 0.5
    i0, j0 = torch.floor(u), torch.floor(v)
    wx, wy = u - i0, v - j0
    return (i0.to(torch.int64).clamp(0, grid - 2),
            j0.to(torch.int64).clamp(0, grid - 2), wx, wy)


def _corners(i0, j0, wx, wy, grid: int):
    c = i0 * grid + j0
    return ((c, (1 - wx) * (1 - wy)), (c + grid, wx * (1 - wy)),
            (c + 1, (1 - wx) * wy), (c + grid + 1, wx * wy))


def taper(d2, rc):
    u = torch.clamp(torch.sqrt(d2 + 1e-12) / rc, max=1.0)
    return u * u * u * (10.0 + u * (6.0 * u - 15.0))


def mesh(pos, src_pos, gm, lo, h, grid: int, rc, eps2, dtype):
    """The tapered mesh force at every row of ``pos``: (N, 2) in dtype.
    The FFTs run in float64 for float64 and in float32 otherwise (no
    FFT takes bfloat16), on values rounded to ``dtype`` before and after."""
    fdt = torch.float64 if dtype == torch.float64 else torch.float32
    dev = pos.device
    rho = torch.zeros(grid * grid, dtype=dtype, device=dev)
    for c, w in _corners(*cic(src_pos, lo, h, grid), grid):
        rho.index_add_(0, c, gm.to(dtype) * w.to(dtype))
    n2 = 2 * grid
    idx = torch.arange(n2, device=dev)
    d = torch.where(idx < grid, idx, idx - n2).to(dtype) * h.to(dtype)
    dx, dy = d[:, None], d[None, :]
    d2 = dx * dx + dy * dy
    r2 = d2 + eps2
    k = taper(d2, rc.to(dtype)) / (r2 * torch.sqrt(r2))
    pad = torch.zeros((n2, n2), dtype=fdt, device=dev)
    pad[:grid, :grid] = rho.reshape(grid, grid).to(fdt)
    f_rho = torch.fft.rfft2(pad)
    field = []
    for kc in (dx * k, dy * k):
        # A(c) = sum_c' rho(c') K(c' - c) = -(rho conv K)(c): K is odd
        a = -torch.fft.irfft2(f_rho * torch.fft.rfft2(kc.to(fdt)), s=(n2, n2))
        field.append(a[:grid, :grid].to(dtype).reshape(-1))
    out = torch.zeros((pos.shape[0], 2), dtype=dtype, device=dev)
    for c, w in _corners(*cic(pos, lo, h, grid), grid):
        w = w.to(dtype)
        out[:, 0] += field[0][c] * w
        out[:, 1] += field[1][c] * w
    return out


def kept(cid, gc: int, cap: int, priority=None):
    """Rows kept by their cells, in cell order (heaviest ``priority`` first
    in a cell where given, else row order; ties in row order): (rows in
    cell order, start of each cell's run, kept count of each cell, and the
    mask over the sorted rows of those kept)."""
    if priority is not None:
        first = torch.argsort(-priority, stable=True)
        order = first[torch.argsort(cid[first], stable=True)]
    else:
        order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=gc * gc)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(cid.shape[0], device=cid.device) - start[cid[order]]
    return order, start, counts.clamp(max=cap), rank < cap


def pair_blocks(pos, cid, src_cid, gm, gc: int, cap: int):
    """The pair sum's candidates: (kept target rows, their cells, the
    source rows in cell order, each cell's source run start and kept
    count, and blocks of kept targets whose candidate pairs stay under
    PAIR_CHUNK), for :func:`pairs` and the roofline's pair count."""
    order_t, _, _, live_t = kept(cid, gc, cap)
    tgt = order_t[live_t]
    order_s, start_s, live_s, _ = kept(src_cid, gc, cap, priority=gm)
    tc = cid[tgt]
    nb = neighbours(tc, gc)
    per_t = torch.where(nb >= 0, live_s[nb.clamp(min=0)], 0).sum(1)
    ends = torch.cumsum(per_t, 0)
    total = int(ends[-1]) if ends.numel() else 0
    marks = torch.arange(PAIR_CHUNK, max(total, PAIR_CHUNK), PAIR_CHUNK,
                         device=ends.device)
    cuts = torch.searchsorted(ends, marks, right=True)
    bounds = [0, *cuts.tolist(), tgt.shape[0]]
    return tgt, tc, order_s, start_s, live_s, list(zip(bounds, bounds[1:]))


def neighbours(tc, gc: int):
    """(T, 9) flat cell of each target's 3×3 neighbours, −1 off the grid."""
    ci, cj = tc // gc, tc % gc
    off = torch.tensor([-1, 0, 1], device=tc.device)
    ni = (ci[:, None] + off[None, :])[:, :, None].expand(-1, 3, 3)
    nj = (cj[:, None] + off[None, :])[:, None, :].expand(-1, 3, 3)
    ok = (ni >= 0) & (ni < gc) & (nj >= 0) & (nj < gc)
    return torch.where(ok, ni * gc + nj, -1).reshape(-1, 9)


def candidates(tc, order_s, start_s, live_s, gc: int, t0: int, t1: int):
    """The candidate pairs of kept targets t0..t1: (index of the target
    among the kept ones, source row), one entry a pair."""
    nb = neighbours(tc[t0:t1], gc)
    k = torch.where(nb >= 0, live_s[nb.clamp(min=0)], 0).reshape(-1)
    st = torch.where(nb >= 0, start_s[nb.clamp(min=0)], 0).reshape(-1)
    seg = torch.repeat_interleave(torch.arange(k.shape[0], device=k.device), k)
    off = torch.arange(seg.shape[0], device=k.device) - (torch.cumsum(k, 0) - k)[seg]
    return t0 + seg // 9, order_s[st[seg] + off]


def pairs(pos, radius, src_pos, gm, blocks, rc, eps2, gc: int, dtype):
    """The short-range correction on every kept target: (N, 2) in dtype."""
    tgt, tc, order_s, start_s, live_s, spans = blocks
    out = torch.zeros((pos.shape[0], 2), dtype=dtype, device=pos.device)
    rc2 = rc.to(dtype) ** 2
    for t0, t1 in spans:
        ti, si = candidates(tc, order_s, start_s, live_s, gc, t0, t1)
        rows = tgt[ti]
        dx = src_pos[si, 0].to(dtype) - pos[rows, 0].to(dtype)
        dy = src_pos[si, 1].to(dtype) - pos[rows, 1].to(dtype)
        d2 = dx * dx + dy * dy
        r2 = d2 + (radius[rows].to(dtype) + SOFTENING_FLOOR)
        q2 = d2 + eps2
        w = gm[si].to(dtype) * (1.0 / (r2 * torch.sqrt(r2))
                                - taper(d2, rc.to(dtype)) / (q2 * torch.sqrt(q2)))
        w = torch.where(d2 < rc2, w, 0.0)
        out.index_add_(0, rows, torch.stack([w * dx, w * dy], 1))
    return out


def acc(pos, radius, gm, cfg: dict, dtype=torch.float64):
    """(N, 2) P³M accelerations at ``pos`` (float32 rows, massive first;
    the sources are the first ``len(gm)`` rows) in ``dtype``."""
    sim = cfg["sim"]
    grid, rc_cells = sim["pm_grid"], sim["p3m_rc_cells"]
    src_pos = pos[:gm.shape[0]]
    lo, h = box(pos, grid)
    rc = rc_cells * h
    eps2 = float(sim["pm_softening"]) ** 2
    out = mesh(pos, src_pos, gm, lo, h, grid, rc, eps2, dtype)
    cid, gc = cells(pos, lo, h, grid, rc_cells)
    blocks = pair_blocks(pos, cid, cid[:gm.shape[0]], gm, gc,
                         sim["p3m_cell_capacity"])
    out += pairs(pos, radius, src_pos, gm, blocks, rc, eps2, gc, dtype)
    k = min(sim["p3m_exact_targets"], pos.shape[0])
    big = torch.argsort(radius, descending=True, stable=True)[:k]
    out[big] = direct_acc(pos[big], radius[big], src_pos, gm, dtype)
    return out


def step(cfg: dict, ref: dict, pos, vel, dtype=torch.float64) -> dict:
    """One substep from (pos, vel): {acc, vel, pos} in ``dtype``."""
    return common.euler_step(acc, cfg, ref, pos, vel, dtype)


def update_parts(cfg: dict, pos, vel, got: dict) -> dict:
    """The update the program's own force and velocity give, as
    {field: (base, increment)}."""
    return common.euler_parts(cfg, pos, vel, got)
