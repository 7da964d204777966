"""Perfectly inelastic collision merging: the contact kernel's wrapper, its
plain PyTorch version, and the merge pass around them.

Counterpart of ``nbody_tpu/ops/collisions.py``. When two live massive
bodies overlap (|d| < factor · (r_i + r_j)), the lighter merges into the
heavier (equal masses: the lower index wins): mass and momentum transfer
exactly, the merged body sits at the pair's center of mass, radii combine
volume-additively (r³ sums), and the absorbed row becomes a massless
tracer of radius 0.5 riding at the merged velocity. Nothing is removed:
an absorbed row keeps its place with mass 0, so ``mass_len`` stays an
upper bound on the rows that exert force. A loser merges only into a
winner that is not itself a loser this pass (a chain A < B < C merges
B into C now and A into C at the next pass), so no winner is zeroed in the
pass that feeds it.

The pass has two halves:
  * the contact search: :func:`contacts` launches ``csrc/merge_contacts.cu``
    on CUDA tensors and takes :func:`contacts_plain` on CPU tensors. The
    kernel examines only the pairs of a cell grid (:func:`contact_grid`
    defines it; the kernel's set-up forms it on the card): the fewer than
    K rows of largest radius against every row, and every other row
    against the rows of its 3×3 neighbourhood of cells, a superset of its
    contacts. Its answer is exact: the plain version's, bit for bit;
  * the scatter (:func:`_merge_scatter`), O(M) PyTorch on both devices. Its
    sums run in row order: ``scatter_add_`` on the CPU (serial), and
    ``index_put_(accumulate=True)`` on the card, which sorts its indices
    (stably) and sums each winner's entries in their order
    (``forces.add_at``). So the card gives the same bits in every run, and
    the CPU the bits of ``nbody_tpu``'s serial scatter.

Nothing in the pass waits for the host: no boolean-mask indexing, no
``nonzero``, no ``.item()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import forces
from ..forces import add_at
from .direct_forces import _check, _device_of, _raise_on

# K: the K-th largest radius of the live rows sets the grid's cell width,
# and the fewer than K rows above it (the big rows) are checked against
# every row. At most MAX_BIG (the kernel's kMaxBig,
# csrc/merge_contacts.cu).
BIG_ROWS = 32
MAX_BIG = 64
# The cell width over the largest reach of two rows off the big set: room
# for the rounding of the float64 cell index (the kernel's note, "Why the
# grid misses no contact"). The kernel holds the same value (kCellMargin).
CELL_MARGIN = 1.0 + 2.0 ** -8
# The largest cell index on either axis (the kernel's kCellMax). Larger
# indices are clamped to it, which only merges cells: each neighbourhood
# stays a superset.
CELL_MAX = 1 << 30
# The key of a row off the grid (dead, a big row, or a non-finite
# position): it sorts after every cell's key.
OFF_GRID = (1 << 63) - 1
# The absorbed row's radius: a standard tracer (galaxy.c:205-206).
TRACER_RADIUS = 0.5

# Kernel launches made by ``contacts`` in this process, one a call (the
# set-up's two kernels, a sort, and the search's three kernels). Plain-
# version calls are not counted. A run resets it to 0 and reads it back.
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("merge_contacts")


class ContactGrid(NamedTuple):
    """The contact search's grid over the M rows of the massive prefix.

    ``big`` (M,) bool: the big rows, whose size (|radius| if live, −inf if
    dead or NaN) exceeds r_cut, the K-th largest size (K = min(BIG_ROWS,
    M)): fewer than K rows; ``order`` (M,) int64: the rows in key order;
    ``keys`` (M,) int64: their keys, sorted, (cy << 32) | cx of the row's
    cell, OFF_GRID off the grid; ``width`` () float64: the cell width;
    ``origin`` (2,) float64: the corner of cell (0, 0)."""

    big: torch.Tensor
    order: torch.Tensor
    keys: torch.Tensor
    width: torch.Tensor
    origin: torch.Tensor


def contact_grid(pos, radius, live, factor: float, *,
                 big_rows: int | None = None) -> ContactGrid:
    """The grid of :func:`contacts` in plain PyTorch: the definition that
    the kernel's own set-up (:func:`contact_grid_kernel`) computes bit for
    bit on the card, and the grid of :func:`contacts_grid_plain`. No host
    sync; its shapes follow from M alone.

    r_cut = max(0, the K-th largest size), so every live row off the big
    set has |r| <= r_cut (a NaN radius touches nothing and is not
    counted). reach = fp32(fp32(2·r_cut) · fp32(|factor|)) is then no
    smaller than |factor · (r_i + r_j)| as the kernel rounds it, for any
    two such rows. The cell width is reach · CELL_MARGIN (1 if that is 0),
    the origin the least x and y of the live rows at finite positions, and
    a row's cell floor((p − origin) / width) in float64, clamped to [0,
    CELL_MAX]. A row is on the grid when it is live, not big, and at a
    finite position (a non-finite position touches nothing).
    ``big_rows``: K, BIG_ROWS by default."""
    m = radius.shape[0]
    k = max(1, min(BIG_ROWS if big_rows is None else big_rows, m))
    inf = float("inf")
    dead = ~live
    size = radius.abs().masked_fill_(dead, -inf).nan_to_num_(
        nan=-inf, posinf=inf)
    r_cut = torch.topk(size, k).values[k - 1:]
    big = size > r_cut
    r_cut = r_cut.clamp(min=0.0)
    # two fp32 values: their product is exact in float64, so this rounds
    # as the kernel's fp32 multiply does
    reach = (r_cut + r_cut).mul_(float(np.float32(abs(factor))))
    width = reach.double().mul_(CELL_MARGIN)
    width.masked_fill_(width == 0.0, 1.0)
    seen = pos.mul(0.0).eq_(0.0).all(1).logical_and_(live)  # finite, live
    p64 = pos.double()
    origin = p64.masked_fill(~seen[:, None], inf).amin(0).nan_to_num_(
        posinf=0.0)
    off = ~(seen & ~big)
    cell = (p64 - origin).div_(width).floor_().clamp_(0.0, float(CELL_MAX))
    cell = cell.masked_fill_(off[:, None], 0.0).long()
    key = (cell[:, 1] << 32).bitwise_or_(cell[:, 0]).masked_fill_(off,
                                                                  OFF_GRID)
    keys, order = torch.sort(key, stable=True)
    return ContactGrid(big, order, keys, width[0], origin)


def _grid_launch(pos, radius, live, factor: float):
    """The kernel's set-up on the card: ``nbody_contact_grid`` (the K-th
    largest size by a radix select in one block, the scalars, each row's
    key, the big rows' list) and one stable sort. Returns (order, sorted
    keys, big (MAX_BIG,) int64 list, counts (2,) int32: the big rows and
    the K-th largest size's ordered bits, scalars (3,) float64: width,
    origin x, origin y)."""
    m = radius.shape[0]
    device = radius.device
    k = max(1, min(BIG_ROWS, m))
    keys = torch.empty(m, dtype=torch.int64, device=device)
    big = torch.empty(MAX_BIG, dtype=torch.int64, device=device)
    counts = torch.empty(2, dtype=torch.int32, device=device)
    scalars = torch.empty(3, dtype=torch.float64, device=device)
    _raise_on(_lib().nbody_contact_grid(
        pos.data_ptr(), radius.data_ptr(), live.data_ptr(), m, float(factor),
        k, keys.data_ptr(), big.data_ptr(), counts.data_ptr(),
        scalars.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "merge_contacts grid")
    keys, order = torch.sort(keys, stable=True)
    return order, keys, big, counts, scalars


def contact_grid_kernel(pos, radius, live, factor: float) -> ContactGrid:
    """:func:`contact_grid` as the kernel's set-up computes it on the card
    (:func:`_grid_launch`), in the same form; it reads the big rows' count
    on the host. For the tests and chip_smoke.py."""
    m = radius.shape[0]
    with torch.cuda.device(radius.device):
        order, keys, big, counts, scalars = _grid_launch(pos, radius, live,
                                                         factor)
    n = int(counts[0])
    mask = torch.zeros(m, dtype=torch.bool, device=radius.device)
    mask[big[:n]] = True
    return ContactGrid(mask, order, keys, scalars[0], scalars[1:])


def neighbour_ranges(grid: ContactGrid) -> tuple:
    """(lo, hi), each (M, 3) int64. For the row at sorted position t, the
    sorted positions [lo, hi) of the rows in cells (cy + d, cx − 1 …
    cx + 1), d = −1, 0, 1: the ranges the kernel finds by binary search.
    Empty off the grid."""
    keys = grid.keys
    on = keys != OFF_GRID
    cy = torch.where(on, keys >> 32, -2)
    cx = torch.where(on, keys & 0xFFFFFFFF, 0)
    rows = cy[:, None] + torch.arange(-1, 2, device=keys.device)
    lo = torch.searchsorted(
        keys, (rows << 32) | (cx - 1).clamp(min=0)[:, None], side="left")
    hi = torch.searchsorted(keys, (rows << 32) | (cx + 1)[:, None],
                            side="right")
    return lo, torch.where(on[:, None] & (rows >= 0), hi, lo)


def grid_candidates(grid: ContactGrid) -> torch.Tensor:
    """() int64: the (target, source) pairs the kernel examines on this
    grid. Each row on it meets the rows of its neighbourhood (itself
    included), and every row meets each big row once, for both directions
    of the pair."""
    lo, hi = neighbour_ranges(grid)
    return (hi - lo).sum() + grid.big.sum() * grid.keys.shape[0]


def _contact_terms(pos, radius, mass, live, factor, tgt, src):
    """JAX's contact rule (``one_tile``) on the (target, source) pairs of
    the index tensors ``tgt`` and ``src`` (broadcast together), each fp32
    expression in its order: (contact, the source's mass)."""
    dx = pos[tgt, 0] - pos[src, 0]
    dy = pos[tgt, 1] - pos[src, 1]
    d2 = dx * dx + dy * dy
    reach = factor * (radius[tgt] + radius[src])
    mt, ms = mass[tgt], mass[src]
    beats = (ms > mt) | ((ms == mt) & (src < tgt))
    return ((d2 < reach * reach) & live[tgt] & live[src] & (tgt != src)
            & beats), ms


def contacts_plain(pos, radius, mass, live, factor: float, *,
                   chunk: int | None = None):
    """Plain version of :func:`contacts`, JAX's ``one_tile`` on chunks of
    ``chunk`` targets at a time (None: a chunk that keeps one (chunk, M)
    temporary at ``forces.CHUNK_ELEMS`` elements). The result is an exact
    max and min, so it does not depend on the chunk."""
    m = mass.shape[0]
    device = mass.device
    if chunk is None:
        chunk = max(1, forces.CHUNK_ELEMS // max(m, 1))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    idx = torch.arange(m, device=device)
    is_loser = torch.zeros(m, dtype=torch.bool, device=device)
    winner = torch.full((m,), m, dtype=torch.int64, device=device)
    for i in range(0, m, chunk):
        t = slice(i, i + chunk)
        contact, ms = _contact_terms(pos, radius, mass, live, factor,
                                     idx[t, None], idx[None, :])
        # heaviest beating contact, ties to the lower index
        key = torch.where(contact, ms, float("-inf"))
        best = key.amax(dim=1)
        at_best = contact & (key == best[:, None])
        is_loser[t] = best > float("-inf")
        winner[t] = torch.where(at_best, idx[None, :], m).amin(dim=1)
    return is_loser, winner


def contacts_grid_plain(pos, radius, mass, live, factor: float, *,
                        big_rows: int | None = None):
    """The kernel's search in plain PyTorch, for the tests: the pairs of
    :func:`contact_grid` (each big row against every row and every row
    against the big rows; each row on the grid against its
    neighbourhood), under JAX's rule, reduced as :func:`contacts_plain`
    reduces them. It equals :func:`contacts_plain` bit for bit exactly
    when the grid misses no contact. Memory O(M · (K + the largest
    neighbourhood)); it reads that size on the host."""
    m = mass.shape[0]
    device = mass.device
    winner = torch.full((m,), m, dtype=torch.int64, device=device)
    if m == 0:
        return winner < 0, winner
    grid = contact_grid(pos, radius, live, factor, big_rows=big_rows)
    lo, hi = neighbour_ranges(grid)
    at = lo[:, :, None] + torch.arange(int((hi - lo).max()), device=device)
    inside = (at < hi[:, :, None]).reshape(m, -1)
    near = grid.order[at.clamp(max=m - 1)].reshape(m, -1)
    rows = torch.arange(m, device=device)
    big = torch.nonzero(grid.big)[:, 0]
    k = big.shape[0]
    big = big[None, :].expand(m, k)
    each = rows[:, None].expand(m, k)
    tgt = torch.cat([grid.order[:, None].expand_as(near), each, big], 1)
    src = torch.cat([near, big, each], 1)
    contact, ms = _contact_terms(pos, radius, mass, live, factor, tgt, src)
    contact[:, :near.shape[1]] &= inside
    tgt, src, contact, ms = (x.reshape(-1) for x in (tgt, src, contact, ms))
    key = torch.where(contact, ms, float("-inf"))
    best = torch.full((m,), float("-inf"), device=device).scatter_reduce(
        0, tgt, key, "amax")
    at_best = contact & (key == best[tgt])
    winner = winner.scatter_reduce(0, tgt, torch.where(at_best, src, m),
                                   "amin")
    return best > float("-inf"), winner


def contacts(pos: torch.Tensor, radius: torch.Tensor, mass: torch.Tensor,
             live: torch.Tensor, factor: float):
    """The contact search over the M rows of the massive prefix: returns
    (is_loser (M,) bool, winner (M,) int64). Row i is a loser when a live
    row j != i in contact (|p_i − p_j|² < (factor·(r_i + r_j))²) beats it
    (heavier, or as heavy with j < i); winner[i] is the heaviest such j,
    the lowest index among equals, and M where there is none. Dead rows
    (``live`` False) neither lose nor win.

    ``pos`` (M, 2), ``radius`` and ``mass`` (M,) fp32, ``live`` (M,) bool,
    all on one device. On CUDA tensors one launch of the kernel: its
    set-up (:func:`contact_grid`'s grid, computed on the card), one stable
    sort, and the search over the grid's pairs; on CPU tensors
    :func:`contacts_plain`."""
    global LAUNCHES
    device = _device_of(mass)
    m = mass.shape[0]
    _check("pos", pos, (m, 2), device)
    _check("radius", radius, (m,), device)
    _check("mass", mass, (m,), device)
    if not isinstance(live, torch.Tensor) or live.dtype != torch.bool:
        raise TypeError("live must be a bool tensor")
    if tuple(live.shape) != (m,) or live.device != device:
        raise ValueError(f"live must have shape ({m},) on {device}, got "
                         f"{tuple(live.shape)} on {live.device}")
    if not live.is_contiguous():
        raise ValueError("live must be contiguous")
    if not 0 <= m < 2**31 - 1:
        raise ValueError(f"at most 2**31 - 2 rows, got {m}")
    if device.type == "cpu":
        return contacts_plain(pos, radius, mass, live, factor)
    winner = torch.empty(m, dtype=torch.int64, device=device)
    if m == 0:
        return winner < 0, winner
    if not 1 <= BIG_ROWS <= MAX_BIG:
        raise ValueError(f"BIG_ROWS must be in [1, {MAX_BIG}] big rows, got "
                         f"{BIG_ROWS}")
    packed = torch.empty((m, 4), dtype=torch.float32, device=device)
    big_keys = torch.empty(MAX_BIG, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        order, keys, big, counts, _ = _grid_launch(pos, radius, live, factor)
        err = _lib().nbody_merge_contacts(
            pos.data_ptr(), radius.data_ptr(), mass.data_ptr(),
            live.data_ptr(), m, float(factor), order.data_ptr(),
            keys.data_ptr(), big.data_ptr(), counts.data_ptr(),
            packed.data_ptr(), big_keys.data_ptr(), winner.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "merge_contacts")
    LAUNCHES += 1
    return winner < m, winner


def _merge_scatter(pos, vel, radius, mass, gm, is_loser, winner, *,
                   g: float):
    """The second half of the pass (nbody_tpu/ops/collisions.py:100-133)
    on the M prefix rows: merge every loser whose winner is no loser."""
    m = gm.shape[0]
    device = gm.device
    idx = torch.arange(m, device=device)
    live = gm > 0.0
    # a loser merges only into a non-loser (defers chains one pass)
    ok = is_loser & ~is_loser[torch.where(winner < m, winner, 0)]
    w = torch.where(ok, winner, idx)          # self-scatter = no-op rows
    okc = ok[:, None]
    new_mass = mass.clone()
    add_at(new_mass, w, torch.where(ok, mass, 0.0))
    # momentum- and center-of-mass-conserving combine
    mom = mass[:, None] * vel
    mx = mass[:, None] * pos
    new_mom, new_mx = mom.clone(), mx.clone()
    add_at(new_mom, w, torch.where(okc, mom, 0.0))
    add_at(new_mx, w, torch.where(okc, mx, 0.0))
    r3 = radius * (radius * radius)           # jnp's integer_pow(r, 3)
    new_r3 = r3.clone()
    add_at(new_r3, w, torch.where(ok, r3, 0.0))
    # winners that absorbed someone (counted in integers, not inferred
    # from the float sums)
    grew = torch.zeros(m, dtype=torch.int32, device=device)
    add_at(grew, w, ok.to(torch.int32))
    grew = grew > 0
    safe = torch.clamp(new_mass, min=1e-30)[:, None]
    pos_w = torch.where(grew[:, None], new_mx / safe, pos)
    vel_w = torch.where(grew[:, None], new_mom / safe, vel)
    rad_w = torch.where(grew, new_r3 ** (1.0 / 3.0), radius)
    # absorbed rows: a massless tracer at the merged body's state
    into = torch.where(ok, w, idx)
    out_pos = torch.where(okc, pos_w.index_select(0, into), pos_w)
    out_vel = torch.where(okc, vel_w.index_select(0, into), vel_w)
    out_mass = torch.where(ok, 0.0, new_mass)
    out_rad = torch.where(ok, TRACER_RADIUS, rad_w)
    out_gm = torch.where(live, g * out_mass, gm)
    return out_pos, out_vel, out_rad, out_mass, out_gm


def _pass(search, pos, vel, radius, mass, gm, *, factor: float, g: float):
    m = gm.shape[0]
    if m == 0:
        return pos, vel, radius, mass, gm
    head = (pos[:m].contiguous(), vel[:m], radius[:m].contiguous(),
            mass[:m].contiguous())
    is_loser, winner = search(head[0], head[2], head[3], gm > 0.0, factor)
    outs = _merge_scatter(*head, gm, is_loser, winner, g=g)
    full = []
    for x, head_out in zip((pos, vel, radius, mass), outs):
        x = x.clone()
        x[:m] = head_out
        full.append(x)
    return (*full, outs[4])


def merge_pass(pos, vel, radius, mass, gm, *, factor: float, g: float):
    """One simultaneous merge resolution over the massive prefix.

    ``pos``/``vel`` (N, 2), ``radius``/``mass`` (N,) are whole rows; ``gm``
    is the source row (length M <= N, the prefix), and ``gm > 0`` is the
    live massive set: only those rows absorb or are absorbed. Returns new
    (pos, vel, radius, mass, gm) with this pass's merges applied; rows past
    M are unchanged and the inputs are not modified. The contact search is
    :func:`contacts` (the kernel on the card)."""
    return _pass(contacts, pos, vel, radius, mass, gm, factor=factor, g=g)


def merge_pass_plain(pos, vel, radius, mass, gm, *, factor: float,
                     g: float, chunk: int | None = None):
    """:func:`merge_pass` with :func:`contacts_plain` as its search, on any
    device (chunks of ``chunk`` targets, see :func:`contacts_plain`)."""
    def search(p, r, mm, live, f):
        return contacts_plain(p, r, mm, live, f, chunk=chunk)

    return _pass(search, pos, vel, radius, mass, gm, factor=factor, g=g)
