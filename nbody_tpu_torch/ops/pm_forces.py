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

The collective form (:func:`pm_acc_collective`, the counterpart of
``nbody_tpu``'s under ``shard_map``) takes one tensor a shard of this
process: every shard of a single-controller world, or this rank's shards of
a world over a process group (``group``, ``ops/collective.py``). The box is
agreed over the shards (JAX's pmin/pmax: a min and a max of every shard's
bounds, gathered onto the first local shard's device), each shard scatters
its own sources into a grid of its own, the grids are gathered and summed
in shard order (JAX's psum, in a fixed order and with no float atomics),
the solve runs once a distinct device, and each shard gathers its own
targets.

The sizes and shapes stay on the device: the box is a pair of 0-dim
tensors, so nothing here waits for the host. Gradients flow as in JAX,
with respect to positions (through the CIC weights) and gm; the box is
computed from detached inputs, as JAX computes it under
``stop_gradient``.
"""

from __future__ import annotations

import torch

from torch.profiler import record_function

from ..forces import add_at
from ..types import DTYPE
from .collective import group_of


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
    sources; with ``tgt_mask`` only the rows it marks non-zero count. The
    inputs are read detached (JAX's ``stop_gradient``): the box is a
    discretization choice and carries no gradient."""
    tgt_pos, src_pos, src_gm = (x.detach() for x in (tgt_pos, src_pos, src_gm))
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


# --- the collective form: one tensor a shard of this process ---

def on_devices(x: torch.Tensor, devices: list) -> list:
    """``x`` on each of ``devices``: one copy a distinct device, shared by
    the shards that live there (the tensor itself on its own device)."""
    copies: dict = {}
    out = []
    for dev in devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out


def shard_sum(xs: list, device) -> torch.Tensor:
    """The sum of the shards' tensors on ``device`` in shard order,
    ((x0 + x1) + x2) + ...: a collective's psum, in a fixed order."""
    with record_function("shards.sum"):
        out = xs[0].to(device)
        for x in xs[1:]:
            out = out + x.to(device)
        return out


def shard_box(tgt_pos: list, src_pos: list, src_gm: list, tgt_mask, grid: int,
              group=None):
    """The box agreed over all shards: each shard's :func:`_bounds`, every
    shard's gathered onto the first local shard's device and their min and
    max formed there in shard order (JAX's pmin and pmax; exact in any
    order), then :func:`_box`. Returns the lists (lo, h), one entry a local
    shard, on the shards' devices."""
    group = group_of(group)
    devices = [t.device for t in tgt_pos]
    dev0 = devices[0]
    masks = tgt_mask if tgt_mask is not None else [None] * len(tgt_pos)
    mins, maxs = [], []
    for t, s, g, m in zip(tgt_pos, src_pos, src_gm, masks):
        if not s.shape[0]:  # no sources: one of gm 0, which no box counts
            s, g = t[:1], torch.zeros_like(t[:1, 0])
        lo_k, hi_k = _bounds(t, s, g, m)
        mins.append(lo_k)
        maxs.append(hi_k)
    mins, maxs = group.gather(mins, dev0), group.gather(maxs, dev0)
    all_min, all_max = mins[0], maxs[0]
    for lo_k, hi_k in zip(mins[1:], maxs[1:]):
        all_min = torch.minimum(all_min, lo_k)
        all_max = torch.maximum(all_max, hi_k)
    lo, h = _box(all_min, all_max, grid)
    return on_devices(lo, devices), on_devices(h, devices)


def per_shard_scalar(x, devices: list) -> list:
    """A float or 0-dim tensor, or a list of one a shard, as one 0-dim fp32
    tensor a shard on its device."""
    xs = x if isinstance(x, (list, tuple)) else [x] * len(devices)
    return [torch.as_tensor(v, dtype=DTYPE, device=dev)
            for v, dev in zip(xs, devices)]


def mesh_grid_collective(src_pos: list, src_gm: list, lo: list, h: list,
                         eps2: list, grid: int, rc=None, group=None) -> list:
    """The collective mesh solve: each shard that holds sources scatters
    them into its own (G, G) grid, the grids of every such shard are
    gathered onto the first local shard's device and summed there in shard
    order, and :func:`_solve` runs once a distinct device (with the P³M
    taper where ``rc``, one 0-dim tensor a shard, is given). Returns the
    (G, G, 2) force grid of each local shard (shards on one device share
    one)."""
    group = group_of(group)
    devices = [p.device for p in src_pos]
    with record_function("p3m.cic_scatter" if rc is not None
                         else "pm.cic_scatter"):
        rhos = [_cic_scatter(s, g, lo_k, 1.0 / h_k, grid) if s.shape[0]
                else None
                for s, g, lo_k, h_k in zip(src_pos, src_gm, lo, h)]
    rhos = group.gather_where(
        rhos, devices[0], [r > 0 for r in group.source_rows(src_pos)],
        (grid, grid))
    if not rhos:
        rhos = [torch.zeros((grid, grid), dtype=DTYPE, device=devices[0])]
    rho = shard_sum(rhos, devices[0])
    solved: dict = {}
    out = []
    with record_function("p3m.fft_solve" if rc is not None
                         else "pm.fft_solve"):
        for k, dev in enumerate(devices):
            if dev not in solved:
                solved[dev] = _solve(rho.to(dev), h[k], eps2[k], grid,
                                     rc=None if rc is None else rc[k])
            out.append(solved[dev])
    return out


def pm_acc_collective(
    tgt_pos: list,      # (T_k, 2) a shard
    src_pos: list,      # (S_k, 2) a shard: the shard's own sources
    src_gm: list,       # (S_k,) a shard
    softening=2.0,
    *,
    grid: int = 512,
    tgt_mask: list | None = None,
    group=None,
) -> list:
    """Sharded particle-mesh (the counterpart of
    ``nbody_tpu.ops.pm_forces.pm_acc_collective``, one tensor a shard of
    this process; ``group`` a ``collective.ShardGroup``, or None for the
    single controller): the box agreed over the shards
    (:func:`shard_box`), each shard's sources scattered into its own grid,
    the grids summed in shard order (:func:`shard_sum`), the solve once a
    distinct device, and each shard's targets gathered from it. Returns (T_k, 2) a shard. A shard
    may hold no sources (S_k = 0). ``softening``: a float, a 0-dim tensor
    or one a shard. Differentiable as :func:`pm_acc`; the box carries no
    gradient."""
    devices = [t.device for t in tgt_pos]
    eps2 = [s ** 2 for s in per_shard_scalar(softening, devices)]
    lo, h = shard_box(tgt_pos, src_pos, src_gm, tgt_mask, grid, group)
    a_grid = mesh_grid_collective(src_pos, src_gm, lo, h, eps2, grid,
                                  group=group)
    with record_function("pm.cic_gather"):
        return [_cic_gather(a, t, lo_k, 1.0 / h_k, grid)
                for a, t, lo_k, h_k in zip(a_grid, tgt_pos, lo, h)]
