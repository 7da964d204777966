"""P³M (particle-particle particle-mesh): accurate O(N) gravity at scale.

Counterpart of the single-device path of ``nbody_tpu/ops/p3m_forces.py``:

  F_total = F_mesh(tapered kernel)  +  F_pp(exact - tapered, pairs d < rc)

* **Mesh stage** (``pm_forces``): the PM solve with the real-space kernel
  multiplied by a smootherstep taper g(d/rc), plain PyTorch as the JAX
  package leaves it to XLA.
* **PP stage**: targets and sources are packed into dense fixed-capacity
  cell blocks (gc, gc, cap) on the same adaptive box (cell size >= rc, so
  every pair closer than rc lies in the 3×3 neighbourhood; gc = grid //
  rc_cells). The pair correction runs in ``p3m_pp.pp_blocks``: the CUDA
  kernel on the card, its plain version on the CPU. Each particle pays one
  gather to pack and one scatter to unpack per substep.
* **Capacity**: cells keep up to ``cell_capacity`` sources, heaviest first
  (a stable sort by -gm, then a stable sort by cell, as ``jnp.lexsort``),
  and up to ``cell_capacity`` targets in their original order. Dropped
  pairs fall back to mesh-only accuracy; ``p3m_cell_overflow`` counts them.
* **Exact cores**: the ``exact_targets`` largest-radius targets get a
  direct-sum row through ``direct_forces.force_acc`` (the CUDA kernel's
  source-split launch on the card) written over the P³M result.

``p3m_bins`` freezes the box, both cell orders and the exact-core rows so a
caller can reuse them for several substeps (``p3m_rebin_interval``);
positions are always read fresh through them. The stages run inside
``torch.profiler.record_function`` ranges named ``p3m.*``, so a profile
splits a substep by stage. Nothing here waits for the host: sizes are
static and every data-dependent quantity stays on the device.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..types import DTYPE
from . import direct_forces, p3m_pp
from .pm_forces import _bounds, _box, _cic_gather, _cic_scatter, _solve


def _taper(d2, rc):
    """Smootherstep 6u⁵-15u⁴+10u³ of u = d/rc, clamped above at 1 (the
    1e-12 bias keeps sqrt's derivative finite at d2 = 0, as in JAX)."""
    u = torch.clamp(torch.sqrt(d2 + 1e-12) / rc, max=1.0)
    return u * u * u * (10.0 + u * (6.0 * u - 15.0))


def _cell_ids(pos, lo, inv_c, gc):
    ij = torch.floor((pos - lo) * inv_c).to(torch.int64).clamp(0, gc - 1)
    return ij[:, 0] * gc + ij[:, 1]


def _cell_pack(pos, lo, inv_c, gc, priority=None):
    """Sort particles by cell (by descending ``priority`` within a cell,
    ties in original order; original order without it) and give each its
    slot: (order, cid, rank, counts), cid/rank in sorted order, counts
    (gc²,) int32. Slot (cid, rank) is unique per particle."""
    n = pos.shape[0]
    cid_raw = _cell_ids(pos, lo, inv_c, gc)
    if priority is not None:
        # jnp.lexsort((-priority, cid)): the last key is the primary one
        first = torch.argsort(-priority, stable=True)
        order = first[torch.argsort(cid_raw[first], stable=True)]
    else:
        order = torch.argsort(cid_raw, stable=True)
    cid = cid_raw[order]
    cells = torch.arange(gc * gc + 1, dtype=cid.dtype, device=cid.device)
    bounds = torch.searchsorted(cid, cells)
    counts = torch.diff(bounds).to(torch.int32)
    rank = torch.arange(n, device=cid.device) - bounds[cid]
    return order, cid, rank, counts


def _gather_blocks(sorted_vals_fills, counts, gc, cap):
    """(gc, gc, cap) contiguous cell blocks from cell-sorted value arrays:
    block[c, k] = vals[starts[c] + k] for k < min(counts[c], cap), else the
    fill (the JAX function's result). Built the other way round from JAX's
    slot gather: each sorted row finds its cell and rank by a binary search
    on the count prefix sums and is written to its slot, so the work scales
    with N rows and one fill of the blocks, not with gc² · cap gathered
    slots (at gc = 512, cap = 768 the blocks hold 201M slots for 1M rows);
    rows past a full cell go to a dropped extra slot."""
    counts = counts.to(torch.int64)
    ends = torch.cumsum(counts, 0)
    rows = torch.arange(sorted_vals_fills[0][0].shape[0], device=counts.device)
    cid = torch.searchsorted(ends, rows, right=True)
    rank = rows - (ends - counts)[cid]
    n_slots = gc * gc * cap
    slot = torch.where(rank < cap, cid * cap + rank, n_slots)
    out = []
    for vals, fill in sorted_vals_fills:
        blocks = torch.full((n_slots + 1,), fill, dtype=DTYPE,
                            device=counts.device)
        blocks[slot] = vals.to(DTYPE)
        out.append(blocks[:n_slots].reshape(gc, gc, cap))
    return out


def _pack_source_blocks(src_pos, src_gm, order_s, counts_s, gc, cap):
    """Sources in (gc, gc, cap) cell blocks (x, y, gm) through their cell
    order (heaviest first in a cell, from ``_cell_pack`` or frozen bins).
    Empty and dropped slots keep gm = 0 and contribute exactly 0."""
    row = torch.cat([src_pos, src_gm[:, None]], dim=-1)[order_s]
    return _gather_blocks(
        [(row[:, 0], 0.0), (row[:, 1], 0.0), (row[:, 2], 0.0)],
        counts_s, gc, cap)


def _pp_unpack(corr_blocks, n, order_t, cid_t, rank_t, cap_t):
    """Per-slot corrections back to original target order: (n, 2). A
    target that overflowed its cell (rank >= cap) gets 0 (mesh only). The
    scatter ``out[order_t] = got`` gives the values of JAX's sort-based
    restore."""
    safe = torch.clamp(rank_t, max=cap_t - 1)
    got = corr_blocks[cid_t, safe]
    got = torch.where((rank_t < cap_t)[:, None], got, 0.0)
    out = torch.empty((n, 2), dtype=DTYPE, device=got.device)
    out[order_t] = got
    return out


def _pp_apply(tgt_pos, tgt_radius, src_blocks, order_t, cid_t, rank_t,
              counts_t, gc, cap_t, rc, eps2, precise, counts_s=None):
    """PP correction (T, 2) of the targets against packed source blocks,
    given the targets' cell assignment. ``counts_s`` (the source counts of
    the blocks) lets the kernel read only occupied source slots."""
    with record_function("p3m.pack"):
        trow = torch.cat([tgt_pos, tgt_radius[:, None]], dim=-1)[order_t]
        # radius fill 1.0: an empty slot stays finite (pp_blocks adds the
        # softening floor to every slot)
        tx, ty, trad = _gather_blocks(
            [(trow[:, 0], 0.0), (trow[:, 1], 0.0), (trow[:, 2], 1.0)],
            counts_t, gc, cap_t)
    with record_function("p3m.pair_kernel"):
        corr = p3m_pp.pp_blocks(tx, ty, trad, *src_blocks, rc, eps2,
                                precise=precise, counts_t=counts_t,
                                counts_s=counts_s)
    with record_function("p3m.unpack"):
        return _pp_unpack(corr, tgt_pos.shape[0], order_t, cid_t, rank_t,
                          cap_t)


def _masked_radius(tgt_radius, tgt_mask):
    """Exact-core selection key: padding rows (mask 0) rank -inf."""
    if tgt_mask is None:
        return tgt_radius
    real = tgt_mask.reshape(-1) != 0.0
    return torch.where(real, tgt_radius, float("-inf"))


def exact_core_rows(tgt_radius, exact_targets, tgt_mask=None):
    """Indices of the ``exact_targets`` largest-radius targets, ties in
    original order (as ``lax.top_k``)."""
    k = min(exact_targets, tgt_radius.shape[0])
    key = _masked_radius(tgt_radius, tgt_mask)
    return torch.argsort(key, descending=True, stable=True)[:k]


def p3m_bins(tgt_pos, tgt_radius, src_pos, src_gm, *, grid: int,
             rc_cells: int, exact_targets: int, tgt_mask=None, big=None):
    """The P³M spatial structure, frozen for reuse across substeps: the
    adaptive box, both cell orders (sources heaviest first, targets
    stable), the per-cell counts and the exact-core rows (``big``, computed
    here unless given)."""
    all_min, all_max = _bounds(tgt_pos, src_pos, src_gm, tgt_mask)
    lo, h = _box(all_min, all_max, grid)
    gc = max(grid // rc_cells, 1)
    cell = (grid * h) / gc  # >= rc, so d < rc pairs lie in 3x3 neighbours
    inv_c = 1.0 / cell
    order_s, _, _, counts_s = _cell_pack(src_pos, lo, inv_c, gc,
                                         priority=src_gm)
    order_t, cid_t, rank_t, counts_t = _cell_pack(tgt_pos, lo, inv_c, gc)
    if big is None:
        big = exact_core_rows(tgt_radius, exact_targets, tgt_mask)
    return {
        "lo": lo, "h": h,
        "order_s": order_s, "counts_s": counts_s,
        "order_t": order_t, "cid_t": cid_t, "rank_t": rank_t,
        "counts_t": counts_t, "big": big,
    }


def p3m_acc_from_bins(bins, tgt_pos, tgt_radius, src_pos, src_gm,
                      softening=2.0, *, grid: int, rc_cells: int,
                      cell_capacity: int, precise: bool = False):
    """P³M accelerations (T, 2) with a frozen spatial structure (see
    :func:`p3m_bins`). With bins built from the same positions this is
    :func:`p3m_acc`; with stale bins the mesh stage and every pair distance
    still use the current positions, only the PP candidates and the box
    lag. ``softening`` may be a float or a 0-dim tensor on the device."""
    device = tgt_pos.device
    eps2 = torch.as_tensor(softening, dtype=DTYPE, device=device) ** 2
    lo, h = bins["lo"], bins["h"]
    rc = rc_cells * h

    with record_function("p3m.cic_scatter"):
        rho = _cic_scatter(src_pos, src_gm, lo, 1.0 / h, grid)
    with record_function("p3m.fft_solve"):
        a_grid = _solve(rho, h, eps2, grid, rc=rc)
    with record_function("p3m.cic_gather"):
        acc = _cic_gather(a_grid, tgt_pos, lo, 1.0 / h, grid)

    gc = max(grid // rc_cells, 1)
    with record_function("p3m.pack"):
        src_blocks = _pack_source_blocks(src_pos, src_gm, bins["order_s"],
                                         bins["counts_s"], gc, cell_capacity)
    acc = acc + _pp_apply(
        tgt_pos, tgt_radius, src_blocks, bins["order_t"], bins["cid_t"],
        bins["rank_t"], bins["counts_t"], gc, cell_capacity, rc, eps2,
        precise, counts_s=bins["counts_s"])

    big = bins["big"]
    if big.shape[0]:
        with record_function("p3m.exact_rows"):
            acc[big] = direct_forces.force_acc(
                tgt_pos[big], tgt_radius[big], src_pos, src_gm,
                precise=precise)
    return acc


def p3m_acc(
    tgt_pos: torch.Tensor,     # (T, 2)
    tgt_radius: torch.Tensor,  # (T,) per-target softening (reference semantics)
    src_pos: torch.Tensor,     # (S, 2), contiguous
    src_gm: torch.Tensor,      # (S,) G * mass (zero rows inert)
    softening: float = 2.0,
    *,
    grid: int = 512,
    rc_cells: int = 4,
    cell_capacity: int = 96,
    exact_targets: int = 64,
    precise: bool = False,
    tgt_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Accelerations on targets: tapered particle-mesh far field + exact
    short-range pair correction + direct-sum rows for the
    ``exact_targets`` largest-radius targets (the counterpart of
    ``nbody_tpu.ops.p3m_forces.p3m_acc``)."""
    bins = p3m_bins(tgt_pos, tgt_radius, src_pos, src_gm, grid=grid,
                    rc_cells=rc_cells, exact_targets=exact_targets,
                    tgt_mask=tgt_mask)
    return p3m_acc_from_bins(bins, tgt_pos, tgt_radius, src_pos, src_gm,
                             softening, grid=grid, rc_cells=rc_cells,
                             cell_capacity=cell_capacity, precise=precise)


def p3m_cell_overflow(src_pos, src_gm, *, grid: int = 512, rc_cells: int = 4,
                      cell_capacity: int = 96) -> torch.Tensor:
    """Number of sources dropped from over-full cells, as a 0-dim int
    tensor on the sources' device (their close pairs degrade to mesh-only
    accuracy). Raise ``cell_capacity`` or the grid if this is a meaningful
    fraction of the sources."""
    all_min, all_max = _bounds(src_pos, src_pos, src_gm, None)
    lo, h = _box(all_min, all_max, grid)
    gc = max(grid // rc_cells, 1)
    cell = (grid * h) / gc
    _, _, _, counts = _cell_pack(src_pos, lo, 1.0 / cell, gc,
                                 priority=src_gm)
    return torch.clamp(counts - cell_capacity, min=0).sum()
