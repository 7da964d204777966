"""P³M (particle-particle particle-mesh): accurate O(N) gravity at scale.

Counterpart of the single-device path of ``nbody_tpu/ops/p3m_forces.py``:

  F_total = F_mesh(tapered kernel)  +  F_pp(exact - tapered, pairs d < rc)

* **Mesh stage** (``pm_forces``): the PM solve with the real-space kernel
  multiplied by a smootherstep taper g(d/rc), plain PyTorch as the JAX
  package leaves it to XLA.
* **PP stage**: particles are binned into cells of the same adaptive box
  (cell size >= rc, so every pair closer than rc lies in the 3×3
  neighbourhood; gc = grid // rc_cells) and sorted by cell. The pair
  correction runs in ``p3m_pp.pp_cells`` on the sorted rows and each
  cell's run (start, count): the CUDA kernel on the card, its plain
  version on the CPU. Each particle pays one gather into cell order and
  one scatter back per substep; no (gc, gc, cap) block is built.
* **Capacity**: cells keep up to ``cell_capacity`` sources, heaviest first
  (a stable sort by -gm, then a stable sort by cell, as ``jnp.lexsort``),
  and up to ``cell_capacity`` targets in their original order: the first
  rows of each cell's run, the slots of ``nbody_tpu``'s cell blocks.
  Dropped pairs fall back to mesh-only accuracy; ``p3m_cell_overflow``
  counts them.
* **Exact cores**: the ``exact_targets`` largest-radius targets get a
  direct-sum row through ``direct_forces.force_acc`` (the CUDA kernel's
  source-split launch on the card) written over the P³M result.

``p3m_bins`` freezes the box, both cell orders and runs and the exact-core
rows so a caller can reuse them for several substeps
(``p3m_rebin_interval``); positions are always read fresh through them.

The collective form (:func:`p3m_acc_collective`, the counterpart of
``nbody_tpu``'s under ``shard_map``) takes one tensor a shard of this
process: every shard of a single-controller world, or this rank's shards
of a world over a process group (``group``, ``ops/collective.py``, whose
gathers put every shard's piece on each rank in shard order, so every rank
forms the same bits as the single controller). Each shard is a target
shard and holds its own sources; the results are ``nbody_tpu``'s:

* the box is agreed over the shards, each shard's source grid is summed
  in shard order (``pm_forces.mesh_grid_collective``);
* the sources of a cell are its global heaviest ``cell_capacity``, ties in
  shard order, then row order: the first rows of each cell's run under one
  stable (−gm, cell) sort of the shards' sources concatenated in shard
  order, which is what JAX's per-cell ``top_k`` over the all-gathered
  panels keeps. The bins hold that order, formed on the first shard's
  device and copied to the others; the positions are gathered fresh at
  every evaluation, once a distinct device;
* a target of cell c on shard k gets a pair correction only if its rank
  in the cell plus the cell's targets on the shards before k (``goff``)
  is below the capacity: each shard launches ``p3m_pp.pp_cells`` on its
  own targets with each cell's count cut to min(count, max(0, cap −
  goff));
* the exact cores are the global top ``exact_targets`` of the shards'
  candidates by masked radius, ties in shard order; each shard with
  sources adds its partial force on them (``direct_forces.force_acc``),
  the partials are summed in shard order, and the owner writes its rows.

JAX's shards also carry their massless and padding rows as sources of gm
0; they sort last in their cells and add exact zeros, and here they are
left out.

Gradients flow as in JAX: through the CIC weights, the FFT solve, the
row gathers into cell order and back, the pair correction
(``p3m_pp.pp_cells``, whose backward is its VJP kernel on the card) and
the exact-core rows (``direct_forces.force_acc``), with respect to
positions, radii and gm. The box is formed from detached inputs (JAX's
``stop_gradient``), so rc and the cells carry no gradient.

The stages run inside ``torch.profiler.record_function`` ranges named
``p3m.*``, so a profile splits a substep by stage. Nothing here waits for
the host: sizes are static and every data-dependent quantity stays on the
device.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import forces
from ..types import DTYPE, SOFTENING_FLOOR
from . import direct_forces, p3m_pp
from .collective import group_of
from .pm_forces import (_bounds, _box, _cic_gather, _cic_scatter, _solve,
                        mesh_grid_collective, on_devices, per_shard_scalar,
                        shard_box, shard_sum)


def _taper(d2, rc):
    """Smootherstep 6u⁵-15u⁴+10u³ of u = d/rc, clamped above at 1 (the
    1e-12 bias keeps sqrt's derivative finite at d2 = 0, as in JAX)."""
    u = torch.clamp(forces.sqrt(d2 + 1e-12) / rc, max=1.0)
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
    """(gc, gc, cap) contiguous cell blocks from cell-sorted value arrays
    (the counterpart of ``nbody_tpu``'s, for ``p3m_pp.pp_blocks``; the main
    path reads the sorted rows directly):
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


class _RowGather(torch.autograd.Function):
    """rows[order] for (n, 4) fp32 rows and a permutation ``order``, each
    row moved as one complex128 element (a copy of its 16 bytes). The
    backward writes the cotangent rows back through the inverse of the
    permutation, 16 bytes a row too: out[order] = g, which is deterministic
    because ``order`` is a permutation."""

    @staticmethod
    def forward(ctx, rows, order):
        ctx.save_for_backward(order)
        return rows.view(torch.complex128)[order].view(DTYPE)

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        out = torch.empty((g.shape[0], 4), dtype=DTYPE, device=g.device)
        out.view(torch.complex128)[order] = g.contiguous().view(
            torch.complex128)
        return out, None


def _cell_rows(xy, w, order):
    """(n, 4) fp32 rows x, y, w, 0 in cell order: ``p3m_pp.pp_cells``'s
    layout (16 bytes a row). The gather moves each row as one complex128
    element, a copy of its bytes: on the card PyTorch gathers 16-byte
    elements many times faster than rows of four fp32 (``chip_smoke.py``
    [8] times both). Differentiable with respect to ``xy`` and ``w``."""
    rows = torch.cat([xy, w[:, None], torch.zeros_like(w)[:, None]], 1)
    return _RowGather.apply(rows, order)


def _run_starts(counts):
    """(gc²,) int32 first row of each cell's run in cell order."""
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


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
    stable), each cell's run in them (start and count, int32) and the
    exact-core rows (``big``, computed here unless given)."""
    all_min, all_max = _bounds(tgt_pos, src_pos, src_gm, tgt_mask)
    lo, h = _box(all_min, all_max, grid)
    gc = max(grid // rc_cells, 1)
    cell = (grid * h) / gc  # >= rc, so d < rc pairs lie in 3x3 neighbours
    inv_c = 1.0 / cell
    order_s, _, _, counts_s = _cell_pack(src_pos, lo, inv_c, gc,
                                         priority=src_gm)
    order_t, _, _, counts_t = _cell_pack(tgt_pos, lo, inv_c, gc)
    if big is None:
        big = exact_core_rows(tgt_radius, exact_targets, tgt_mask)
    return {
        "lo": lo, "h": h,
        "order_s": order_s, "start_s": _run_starts(counts_s),
        "counts_s": counts_s,
        "order_t": order_t, "start_t": _run_starts(counts_t),
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

    order_t = bins["order_t"]
    with record_function("p3m.pack"):
        trows = _cell_rows(tgt_pos, tgt_radius + SOFTENING_FLOOR, order_t)
        srows = _cell_rows(src_pos, src_gm, bins["order_s"])
    with record_function("p3m.pair_kernel"):
        corr = p3m_pp.pp_cells(
            trows, srows, bins["start_t"], bins["counts_t"], bins["start_s"],
            bins["counts_s"], rc, eps2, cap_t=cell_capacity,
            cap_s=cell_capacity, precise=precise)
    with record_function("p3m.unpack"):
        # a target past its cell's capacity got 0 (mesh only)
        pp = torch.empty_like(corr)
        pp[order_t] = corr
    acc = acc + pp

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


# --- the collective form: one tensor a shard of this process ---

def _top_rows(key: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest keys, ties in index order (as
    ``lax.top_k``)."""
    return torch.argsort(key, descending=True, stable=True)[:k]


def p3m_exact_core_bins_collective(tgt_radius: list, *, exact_targets: int,
                                   tgt_mask: list | None = None,
                                   group=None) -> dict:
    """The exact-core selection over the shards (radius is constant in a
    run, so a caller makes it once and passes it on as ``big_bins``):
    each shard's top min(``exact_targets``, rows) rows by masked radius
    (``big_i_loc``, on its device), the global top ``exact_targets`` of
    every shard's candidates, ties in shard order (``big_sel``, indices
    into the candidates in shard order), their radii (``big_radius``) on
    the first local shard's device, and for each local shard the row it
    writes for each selected row (``big_row``: the local row where it owns
    it, else the row count, one past its rows)."""
    group = group_of(group)
    devices = [r.device for r in tgt_radius]
    dev0 = devices[0]
    n_loc = tgt_radius[0].shape[0]
    k_loc = min(exact_targets, n_loc)
    first = group.first(len(devices))
    masks = tgt_mask if tgt_mask is not None else [None] * len(tgt_radius)
    i_loc = [_top_rows(_masked_radius(r, m), k_loc)
             for r, m in zip(tgt_radius, masks)]
    cand_key = torch.cat(group.gather(
        [_masked_radius(r, m)[i] for r, m, i in zip(tgt_radius, masks, i_loc)],
        dev0))
    cand_r = torch.cat(group.gather(
        [r[i] for r, i in zip(tgt_radius, i_loc)], dev0))
    cand_i = torch.cat(group.gather(i_loc, dev0))
    sel = _top_rows(cand_key, min(exact_targets,
                                  group.n_shards(len(devices)) * k_loc))
    owner = sel // max(k_loc, 1)
    rows = cand_i[sel]
    return {
        "big_i_loc": i_loc,
        "big_sel": sel,
        "big_radius": cand_r[sel],
        "big_row": [torch.where(owner == first + k, rows, n_loc).to(dev)
                    for k, dev in enumerate(devices)],
    }


def p3m_bins_collective(tgt_pos: list, tgt_radius: list, src_pos: list,
                        src_gm: list, *, grid: int, rc_cells: int,
                        cell_capacity: int, exact_targets: int,
                        tgt_mask: list | None = None,
                        big_bins: dict | None = None, group=None) -> dict:
    """The collective counterpart of :func:`p3m_bins`, frozen for reuse
    across substeps: the box agreed over the shards (``lo``, ``h``: one a
    local shard); the global source order (``order_s``, ``start_s``,
    ``counts_s``: over every shard's sources concatenated in shard order,
    one copy a distinct local device); each local shard's target order,
    runs and counts (``order_t``, ``start_t``, ``counts_t``), the count of
    each cell's targets on the shards before it (``goff``) and the counts
    cut by the global-rank rule (``cut_t``); and the exact-core selection
    (:func:`p3m_exact_core_bins_collective`, or ``big_bins``). Positions
    are read detached: the bins carry no gradient."""
    group = group_of(group)
    devices = [p.device for p in tgt_pos]
    dev0 = devices[0]
    cap = cell_capacity
    gc = max(grid // rc_cells, 1)
    tgt_pos = [p.detach() for p in tgt_pos]
    lo, h = shard_box(tgt_pos, src_pos, src_gm, tgt_mask, grid, group)
    inv_c = [1.0 / ((grid * h_k) / gc) for h_k in h]
    rows = group.source_rows(src_pos)
    src_all = torch.cat(group.gather([p.detach() for p in src_pos], dev0,
                                     rows))
    gm_all = torch.cat(group.gather([g.detach() for g in src_gm], dev0, rows))
    order_s, _, _, counts_s = _cell_pack(src_all, lo[0], inv_c[0], gc,
                                         priority=gm_all)
    bins = {"lo": lo, "h": h,
            "order_s": on_devices(order_s, devices),
            "start_s": on_devices(_run_starts(counts_s), devices),
            "counts_s": on_devices(counts_s, devices),
            "order_t": [], "start_t": [], "counts_t": [], "goff": [],
            "cut_t": []}
    packs = [_cell_pack(p, lo_k, ic, gc)
             for p, lo_k, ic in zip(tgt_pos, lo, inv_c)]
    goff = torch.zeros(gc * gc, dtype=torch.int32, device=dev0)
    if group.size > 1:  # the cells' targets on the earlier ranks' shards
        counts = group.gather([c for *_, c in packs], dev0)
        for c in counts[:group.first(len(devices))]:
            goff = goff + c
    for (order_t, _, _, counts_t), dev in zip(packs, devices):
        goff = goff.to(dev)
        bins["order_t"].append(order_t)
        bins["start_t"].append(_run_starts(counts_t))
        bins["counts_t"].append(counts_t)
        bins["goff"].append(goff)
        bins["cut_t"].append(torch.minimum(
            counts_t, torch.clamp(cap - goff, min=0)).to(torch.int32))
        goff = goff + counts_t
    if exact_targets:
        bins.update(big_bins if big_bins is not None else
                    p3m_exact_core_bins_collective(
                        tgt_radius, exact_targets=exact_targets,
                        tgt_mask=tgt_mask, group=group))
    return bins


def _write_rows(acc: torch.Tensor, rows: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """acc with acc[rows[i]] = vals[i] where rows[i] < len(acc); the rows
    past the end are dropped (JAX's ``.at[].set(mode="drop")``), through
    one extra row that is cut off. Out of place and differentiable."""
    ext = torch.cat([acc, acc.new_zeros((1,) + tuple(acc.shape[1:]))])
    return ext.index_put((rows,), vals)[:acc.shape[0]]


def p3m_acc_collective_from_bins(bins: dict, tgt_pos: list, tgt_radius: list,
                                 src_pos: list, src_gm: list, softening=2.0,
                                 *, grid: int, rc_cells: int,
                                 cell_capacity: int, precise: bool = False,
                                 group=None) -> list:
    """Sharded P³M with a frozen collective structure (see
    :func:`p3m_bins_collective`): with fresh bins this is
    :func:`p3m_acc_collective`; with stale ones every position is still
    read fresh (mesh scatter and gather, pair distances, exact-core rows),
    and only the candidates and the box lag. Returns (T_k, 2) a local
    shard, the padding rows' values unmasked (the caller masks them). Each
    shard makes one ``pp_cells`` launch; each shard that holds sources
    makes one ``force_acc`` launch for the exact-core rows."""
    group = group_of(group)
    devices = [p.device for p in tgt_pos]
    dev0 = devices[0]
    cap = cell_capacity
    lo, h = bins["lo"], bins["h"]
    soft = per_shard_scalar(softening, devices)
    eps2 = [s ** 2 for s in soft]
    rc = [rc_cells * h_k for h_k in h]
    a_grid = mesh_grid_collective(src_pos, src_gm, lo, h, eps2, grid, rc=rc,
                                  group=group)
    with record_function("p3m.cic_gather"):
        acc = [_cic_gather(a, t, lo_k, 1.0 / h_k, grid)
               for a, t, lo_k, h_k in zip(a_grid, tgt_pos, lo, h)]

    rows = group.source_rows(src_pos)
    with record_function("p3m.pack"):
        xy = torch.cat(group.gather(src_pos, dev0, rows))
        w = torch.cat(group.gather(src_gm, dev0, rows))
        srows: dict = {}
        for k, dev in enumerate(devices):
            if dev not in srows:
                srows[dev] = _cell_rows(xy.to(dev), w.to(dev),
                                        bins["order_s"][k])
        trows = [_cell_rows(p, r + SOFTENING_FLOOR, o) for p, r, o in
                 zip(tgt_pos, tgt_radius, bins["order_t"])]
    out = []
    for k, dev in enumerate(devices):
        with record_function("p3m.pair_kernel"):
            corr = p3m_pp.pp_cells(
                trows[k], srows[dev], bins["start_t"][k], bins["cut_t"][k],
                bins["start_s"][k], bins["counts_s"][k], rc[k], eps2[k],
                cap_t=cap, cap_s=cap, precise=precise)
        with record_function("p3m.unpack"):
            pp = torch.empty_like(corr)
            pp[bins["order_t"][k]] = corr
        out.append(acc[k] + pp)

    if "big_sel" in bins and bins["big_sel"].shape[0]:
        with record_function("p3m.exact_rows"):
            cand = torch.cat(group.gather(
                [p[i] for p, i in zip(tgt_pos, bins["big_i_loc"])], dev0))
            big_pos = cand[bins["big_sel"]]
            partial = group.gather_where(
                [direct_forces.force_acc(
                    big_pos.to(dev), bins["big_radius"].to(dev), s, g,
                    precise=precise) if s.shape[0] else None
                 for s, g, dev in zip(src_pos, src_gm, devices)],
                dev0, [r > 0 for r in rows], tuple(big_pos.shape))
            exact = (shard_sum(partial, dev0) if partial
                     else torch.zeros_like(big_pos))
            out = [_write_rows(a, r, exact.to(a.device))
                   for a, r in zip(out, bins["big_row"])]
    return out


def p3m_acc_collective(
    tgt_pos: list,      # (T_k, 2) a shard
    tgt_radius: list,   # (T_k,) a shard
    src_pos: list,      # (S_k, 2) a shard: the shard's own sources
    src_gm: list,       # (S_k,) a shard
    softening=2.0,
    *,
    grid: int = 512,
    rc_cells: int = 4,
    cell_capacity: int = 96,
    exact_targets: int = 64,
    precise: bool = False,
    tgt_mask: list | None = None,
    group=None,
) -> list:
    """Sharded P³M (the counterpart of
    ``nbody_tpu.ops.p3m_forces.p3m_acc_collective``, one tensor a shard of
    this process; ``group`` a ``collective.ShardGroup``, or None for the
    single controller): fresh :func:`p3m_bins_collective`, then
    :func:`p3m_acc_collective_from_bins`. Returns (T_k, 2) a shard."""
    bins = p3m_bins_collective(
        tgt_pos, tgt_radius, src_pos, src_gm, grid=grid, rc_cells=rc_cells,
        cell_capacity=cell_capacity, exact_targets=exact_targets,
        tgt_mask=tgt_mask, group=group)
    return p3m_acc_collective_from_bins(
        bins, tgt_pos, tgt_radius, src_pos, src_gm, softening, grid=grid,
        rc_cells=rc_cells, cell_capacity=cell_capacity, precise=precise,
        group=group)
