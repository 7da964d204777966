"""P³M pair correction: the CUDA kernel's wrappers and their plain PyTorch
versions.

Counterpart of ``pp_blocks`` in ``nbody_tpu/ops/p3m_pallas.py`` (the Pallas
kernel ``_pp_kernel`` and its jnp twin ``_pp_blocks_jnp``). In the JAX
package that kernel is a tested alternative and the production PP stage is
an XLA map; in the port, ``csrc/p3m_pp.cu`` is the PP stage on the card.

Each live target of cell (i, j) meets every live source of the 3×3
neighbour cells; for pairs with d² < rc² it adds
``gm · (exact³ − taper(d/rc) · smooth³) · (dx, dy)``, the exact softened
force minus what the tapered mesh already delivered. Neighbours outside the
grid contribute nothing. Both versions form the taper's u as
``sqrt(d² + 1e-12) · (1/rc)``, with 1/rc rounded in fp32 as the Pallas
kernel's caller forms it. ``rc`` and ``eps2`` may be Python floats or 0-dim
tensors on the inputs' device (the p3m path's rc follows the adaptive box):
the kernel reads them from device memory, so no call waits for the host.

Two entry points, one kernel:

* :func:`pp_cells`, the main path's: the particles in cell order as rows
  (targets x, y, radius + SOFTENING_FLOOR, 0; sources x, y, gm, 0) and each
  cell's run (start, count) on both sides. Only a run's first ``cap`` rows
  take part, the slots the JAX blocks hold; the result is one (x, y) a
  target row, 0 for the rows past a cell's cap, and past its count where
  the count is below the run's length (the sharded P³M's target cut).
* :func:`pp_blocks`, the counterpart of ``nbody_tpu``'s: packed
  (gc, gc, cap) blocks in, (gc², cap_t, 2) out. On the card it runs the
  same kernel on the blocks written as rows, cell c's run at c · cap.

``pp_cells`` is differentiable with respect to columns 0-2 of its rows
(x, y, r + floor of the targets; x, y, gm of the sources): a
``torch.autograd.Function`` whose backward is :func:`pp_cells_vjp`, the
VJP of ``_pp_blocks_jnp`` (the adjoint that ``nbody_tpu``'s ``pp_blocks``
recomputes at backward time) on the same slots, taper and ``d² < rc²``
mask included. On the card it is ``csrc/p3m_pp_vjp.cu`` (one pass over
the pairs, cut as :func:`vjp_plan` says); on the CPU,
:func:`pp_cells_vjp_plain`. The runs,
``rc`` and ``eps2`` get no gradient: the p3m path forms rc from a box that
is detached, as JAX's is under ``stop_gradient``, and the softening is a
constant.

Dispatch is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import forces
from ..types import DTYPE, SOFTENING_FLOOR

# Kernel launches made by ``pp_cells`` and ``pp_blocks`` in this process
# (plain-version calls are not counted). A run resets it to 0 and reads it
# back.
LAUNCHES = 0

# Kernel launches of the VJP (csrc/p3m_pp_vjp.cu): each call of
# ``pp_cells_vjp`` on the card makes one pass over the pairs and adds 1
# (the fixed-order sums of its partials are part of it).
VJP_LAUNCHES = 0

# The VJP's plan (:func:`vjp_plan`): the most rows of a target cell's
# neighbourhood one task walks for each of the cell's tiles (R, a multiple
# of 8 up to 1536), and the tiles from which a cell's tasks are taken
# first. R sets the order of each target's sums, so it is fixed.
VJP_RANGE = 512
VJP_HEAVY_TILES = 4

# Targets a kernel task: one warp, one target a lane (csrc/p3m_pp.cu).
TILE = 32

# Elements of one (cells, cap_t, 9·cap_s) pair temporary in the plain
# version: 2**24 fp32 is 64 MiB, and about ten such temporaries are alive
# at once.
PLAIN_CHUNK_ELEMS = 1 << 24


def _scalars(rc, eps2, device) -> torch.Tensor:
    """(3,) fp32 on ``device``: rc, eps2 and 1/rc formed in fp32."""
    rc = torch.as_tensor(rc, dtype=DTYPE, device=device)
    eps2 = torch.as_tensor(eps2, dtype=DTYPE, device=device)
    return torch.stack([rc, eps2, 1.0 / rc])


def _neighbour_cells(cells: torch.Tensor, gc: int) -> torch.Tensor:
    """(len(cells), 9) flat indices of each cell's 3×3 neighbours in the
    (gc+2)² zero-ringed grid, row offset outer, column offset inner (the
    order in which ``_pp_blocks_jnp`` concatenates them)."""
    i = cells // gc
    j = cells % gc
    off = torch.arange(3, device=cells.device)
    rows = (i[:, None] + off[None, :])[:, :, None]
    cols = (j[:, None] + off[None, :])[:, None, :]
    return (rows * (gc + 2) + cols).reshape(-1, 9)


def _slot_mask(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(gc², cap) bool: slot k of cell c is below min(counts[c], cap)."""
    slot = torch.arange(cap, device=counts.device)
    return slot[None, :] < counts.reshape(-1, 1)


def _pp_plain(tx, ty, trs, sx, sy, sg, rc, eps2, precise, counts_t, counts_s):
    """The plain pair correction on blocks whose target radii ``trs``
    already hold the softening floor, a chunk of cells at a time (memory
    O(chunk · cap_t · 9 cap_s)). With ``counts_t`` only cells that hold
    targets are computed; finding them reads the counts on the host."""
    gc, _, cap_t = tx.shape
    cap_s = sx.shape[-1]
    rc, eps2, inv_rc = _scalars(rc, eps2, tx.device)
    rc2 = rc * rc
    if counts_s is not None:
        sg = torch.where(_slot_mask(counts_s, cap_s).reshape(sg.shape), sg, 0.0)
    pad = [torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1)).reshape(-1, cap_s)
           for a in (sx, sy, sg)]
    txf, tyf, trf = (a.reshape(gc * gc, cap_t) for a in (tx, ty, trs))
    out = torch.zeros((gc * gc, cap_t, 2), dtype=DTYPE, device=tx.device)
    if counts_t is None:
        todo = torch.arange(gc * gc, device=tx.device)
    else:
        todo = torch.nonzero(counts_t.reshape(-1) > 0).reshape(-1)
    chunk = max(1, PLAIN_CHUNK_ELEMS // (cap_t * 9 * cap_s))
    for c0 in range(0, todo.shape[0], chunk):
        cells = todo[c0:c0 + chunk]
        nb = _neighbour_cells(cells, gc)
        nsx, nsy, nsg = (p[nb].reshape(len(cells), 9 * cap_s) for p in pad)
        dx = nsx[:, None, :] - txf[cells][:, :, None]   # (m, cap_t, 9 cap_s)
        dy = nsy[:, None, :] - tyf[cells][:, :, None]
        d2 = dx * dx + dy * dy
        r2 = d2 + trf[cells][:, :, None]
        q2 = d2 + eps2
        if precise:
            exact3 = 1.0 / (forces.sqrt(r2) * r2)
            smooth3 = 1.0 / (forces.sqrt(q2) * q2)
        else:
            inv = torch.rsqrt(r2)
            exact3 = inv * inv * inv
            invq = torch.rsqrt(q2)
            smooth3 = invq * invq * invq
        u = torch.clamp(forces.sqrt(d2 + 1e-12) * inv_rc, max=1.0)
        taper = u * u * u * (10.0 + u * (6.0 * u - 15.0))
        w = nsg[:, None, :] * (exact3 - taper * smooth3)
        w = torch.where(d2 < rc2, w, 0.0)
        out[cells, :, 0] = (w * dx).sum(-1)
        out[cells, :, 1] = (w * dy).sum(-1)
    if counts_t is not None:
        out = out * _slot_mask(counts_t, cap_t)[..., None]
    return out


def pp_blocks_plain(tx, ty, tr, sx, sy, sg, rc, eps2, *, precise: bool = False,
                    counts_t=None, counts_s=None) -> torch.Tensor:
    """Plain version of :func:`pp_blocks`."""
    return _pp_plain(tx, ty, tr + SOFTENING_FLOOR, sx, sy, sg, rc, eps2,
                     precise, counts_t, counts_s)


def run_slots(start: torch.Tensor, counts: torch.Tensor, cap: int,
              n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gc², cap) int64 row of every slot of the runs, and whether the slot
    is live: slot k of cell c is row start[c] + k, live for k <
    min(counts[c], cap) inside the rows."""
    k = torch.arange(cap, device=start.device)
    idx = start.to(torch.int64)[:, None] + k
    live = (k < counts.clamp(max=cap)[:, None]) & (idx < n_rows)
    return idx, live


def _runs_to_blocks(rows, start, counts, cap, fill):
    """(gc², cap, 4) blocks of the runs' first ``cap`` rows, ``fill`` in
    the other slots; and the slots' rows and live mask (:func:`run_slots`)."""
    n = rows.shape[0]
    idx, live = run_slots(start, counts, cap, n)
    padded = torch.cat([rows, torch.tensor([fill], dtype=DTYPE,
                                           device=rows.device)])
    return padded[torch.where(live, idx, n)], idx, live


def pp_cells_plain(trows, srows, start_t, counts_t, start_s, counts_s, rc,
                   eps2, *, cap_t: int, cap_s: int,
                   precise: bool = False) -> torch.Tensor:
    """Plain version of :func:`pp_cells`: the runs packed into blocks (an
    empty target slot holds radius 1, a finite value), the plain block
    correction on them, and its live slots taken back to their rows."""
    gc = math.isqrt(counts_t.numel())
    tb, idx, live = _runs_to_blocks(trows, start_t, counts_t, cap_t,
                                    (0.0, 0.0, 1.0, 0.0))
    sb, _, _ = _runs_to_blocks(srows, start_s, counts_s, cap_s,
                               (0.0, 0.0, 0.0, 0.0))
    blocks = [b[..., k].reshape(gc, gc, -1) for b in (tb, sb) for k in range(3)]
    corr = _pp_plain(*blocks, rc, eps2, precise, counts_t, counts_s)
    out = torch.zeros((trows.shape[0], 2), dtype=DTYPE, device=trows.device)
    out[idx[live]] = corr[live]
    return out


def _check_device(device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"p3m_pp runs on CPU or CUDA tensors, got {device}")


def _check_float(name, a, shape, device) -> None:
    if not isinstance(a, torch.Tensor) or a.dtype != DTYPE:
        raise TypeError(f"{name} must be a float32 tensor")
    if tuple(a.shape) != tuple(shape) or a.device != device \
            or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor "
                         f"on {device}, got {tuple(a.shape)} on {a.device}")


def _check_index(name, c, n, device) -> None:
    if not isinstance(c, torch.Tensor) or c.dtype != torch.int32 \
            or c.shape != (n,) or c.device != device or not c.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor of "
                         f"gc² = {n} cells on {device}")


def _check_blocks(blocks, counts, device):
    (tx, ty, tr), (sx, sy, sg) = blocks
    gc, gc2, cap_t = tx.shape
    if gc != gc2 or sx.shape[:2] != tx.shape[:2]:
        raise ValueError(f"blocks must be (gc, gc, cap), got {tuple(tx.shape)} "
                         f"and {tuple(sx.shape)}")
    for name, a, shape in (("tx", tx, tx.shape), ("ty", ty, tx.shape),
                           ("tr", tr, tx.shape), ("sx", sx, sx.shape),
                           ("sy", sy, sx.shape), ("sg", sg, sx.shape)):
        _check_float(name, a, shape, device)
    for name, c in counts.items():
        if c is not None:
            _check_index(name, c, gc * gc, device)


def _check_cells(trows, srows, runs, cap_t, cap_s, device) -> int:
    """The grid side gc of valid :func:`pp_cells` inputs; raises on others."""
    for name, rows in (("trows", trows), ("srows", srows)):
        if not isinstance(rows, torch.Tensor) or rows.dim() != 2:
            raise ValueError(f"{name} must be an (n, 4) tensor")
        _check_float(name, rows, (rows.shape[0], 4), device)
    n = runs["counts_t"].numel() if isinstance(runs["counts_t"],
                                                torch.Tensor) else 0
    gc = math.isqrt(n)
    if n == 0 or gc * gc != n:
        raise ValueError(f"counts_t must hold gc² > 0 cells, got {n}")
    for name, c in runs.items():
        _check_index(name, c, n, device)
    for name, cap in (("cap_t", cap_t), ("cap_s", cap_s)):
        if not isinstance(cap, int) or cap < 1:
            raise ValueError(f"{name} must be a positive int, got {cap!r}")
    return gc


def _tasks(counts, cap: int, n_rows: int, gc: int):
    """A pass's task list on the device: (tile_end, max_tasks). tile_end is
    the inclusive prefix sum of ceil(min(counts, cap) / TILE) over the
    cells; max_tasks bounds its last entry from the host-known sizes, one
    task a tile of TILE rows: at most ceil(n_rows / TILE) full tiles plus
    one partial tile a cell that holds rows."""
    max_tasks = -(-n_rows // TILE) + min(gc * gc, n_rows)
    tiles = (counts.clamp(max=cap) + (TILE - 1)) // TILE
    return torch.cumsum(tiles, 0, dtype=torch.int32), max_tasks


def _check_kernel_rows(trows, srows, max_tasks) -> None:
    if max(trows.shape[0], srows.shape[0], max_tasks) >= 2 ** 31:
        raise ValueError("p3m_pp: the kernel indexes rows and tasks in int32")
    if trows.data_ptr() % 16 or srows.data_ptr() % 16:
        raise ValueError("p3m_pp: the row arrays must be 16-byte aligned")


def _launch(trows, srows, start_t, counts_t, start_s, counts_s, gc, cap_t,
            cap_s, rc, eps2, precise) -> torch.Tensor:
    """The kernel on runs of rows: (n_t, 2), zeros outside the live rows."""
    global LAUNCHES
    from . import _build

    device = trows.device
    n_t, n_s = trows.shape[0], srows.shape[0]
    tile_end, max_tasks = _tasks(counts_t, cap_t, n_t, gc)
    _check_kernel_rows(trows, srows, max_tasks)
    out = torch.zeros((n_t, 2), dtype=DTYPE, device=device)
    if max_tasks == 0:
        return out
    scal = _scalars(rc, eps2, device)
    with torch.cuda.device(device):
        err = _build.load("p3m_pp").nbody_p3m_pp(
            trows.data_ptr(), n_t, srows.data_ptr(), n_s, start_t.data_ptr(),
            counts_t.data_ptr(), start_s.data_ptr(), counts_s.data_ptr(),
            tile_end.data_ptr(), gc, cap_t, cap_s, max_tasks, scal.data_ptr(),
            int(precise), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"p3m_pp kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _no_grad_scalar(x):
    """rc or eps2 as the pair correction takes it: a float, or a 0-dim
    tensor detached from any graph (the runs' box carries no gradient)."""
    return x.detach() if isinstance(x, torch.Tensor) else x


class _PPCells(torch.autograd.Function):
    """:func:`pp_cells` with its VJP: only the rows and runs are saved,
    and the backward recomputes the pair terms (:func:`pp_cells_vjp`)."""

    @staticmethod
    def forward(ctx, trows, srows, start_t, counts_t, start_s, counts_s, rc,
                eps2, gc, cap_t, cap_s, precise):
        ctx.save_for_backward(trows, srows, start_t, counts_t, start_s,
                              counts_s)
        ctx.cfg = (rc, eps2, cap_t, cap_s, precise)
        if trows.device.type == "cpu":
            return pp_cells_plain(trows, srows, start_t, counts_t, start_s,
                                  counts_s, rc, eps2, cap_t=cap_t,
                                  cap_s=cap_s, precise=precise)
        return _launch(trows, srows, start_t, counts_t, start_s, counts_s, gc,
                       cap_t, cap_s, rc, eps2, precise)

    @staticmethod
    def backward(ctx, g):
        rc, eps2, cap_t, cap_s, precise = ctx.cfg
        d_t, d_s = pp_cells_vjp(*ctx.saved_tensors, rc, eps2, g.contiguous(),
                                cap_t=cap_t, cap_s=cap_s, precise=precise)
        return (d_t, d_s) + (None,) * 10


def pp_cells(
    trows: torch.Tensor,     # (n_t, 4) targets in cell order: x, y, r + floor, 0
    srows: torch.Tensor,     # (n_s, 4) sources in cell order: x, y, gm, 0
    start_t: torch.Tensor,   # (gc²,) int32 first row of each cell's targets
    counts_t: torch.Tensor,  # (gc²,) int32 targets in each cell
    start_s: torch.Tensor,   # (gc²,) int32 first row of each cell's sources
    counts_s: torch.Tensor,  # (gc²,) int32 sources in each cell
    rc: float | torch.Tensor, eps2: float | torch.Tensor, *,
    cap_t: int, cap_s: int, precise: bool = False,
) -> torch.Tensor:
    """Per-target P³M pair correction on cell-sorted rows: (n_t, 2) fp32 in
    the rows' order. The first min(counts_t[c], cap_t) targets of cell c
    meet the first min(counts_s[n], cap_s) sources of each neighbour cell
    n, the slots that ``nbody_tpu``'s (gc, gc, cap) blocks hold; every
    other row is 0 (a target past its cell's cap keeps the mesh force
    only). A count may be below its run's length: the rows of the run
    past it are 0 and the rows before it get the bits they get with the
    whole run. That is the target cut of the sharded P³M (each shard's
    counts cut by the cell's targets on the shards before it,
    ``p3m_forces.p3m_bins_collective``). The runs must lie inside the
    rows. The call makes no host sync. Differentiable with respect to
    ``trows`` and ``srows``; the backward is :func:`pp_cells_vjp`, on the
    same counts."""
    device = trows.device
    _check_device(device)
    runs = {"start_t": start_t, "counts_t": counts_t, "start_s": start_s,
            "counts_s": counts_s}
    gc = _check_cells(trows, srows, runs, cap_t, cap_s, device)
    return _PPCells.apply(trows, srows, start_t, counts_t, start_s, counts_s,
                          _no_grad_scalar(rc), _no_grad_scalar(eps2), gc,
                          cap_t, cap_s, precise)


def _pair_vjp_terms(dx, dy, tr, gm, gx, gy, rc2, eps2, inv_rc, precise):
    """The VJP terms of the pairs (d = source − target, target softening
    ``tr``, source ``gm``, target cotangent (gx, gy)), broadcast together:
    (cx, cy, e_tr, e_gm), zero outside d² < rc². With
    h = exact³ − taper·smooth³, w = gm·h, s = g·d and ps = s·gm:
    c = w·g + 2·(te − tt − taper·ts)·d, e_tr = te, e_gm = s·h, where
    te = −1.5·exact³·ps / r2, ts = −1.5·smooth³·ps / q2 and
    tt = taper'(u)·(0.5 / sqrt(d² + 1e-12))·(1/rc)·smooth³·ps
    (taper'(u) = 30u²(1 − u)² below the clamp, 0 at it)."""
    d2 = dx * dx + dy * dy
    r2 = d2 + tr
    q2 = d2 + eps2
    if precise:
        exact3 = 1.0 / (forces.sqrt(r2) * r2)
        smooth3 = 1.0 / (forces.sqrt(q2) * q2)
    else:
        inv = torch.rsqrt(r2)
        exact3 = inv * inv * inv
        invq = torch.rsqrt(q2)
        smooth3 = invq * invq * invq
    su = forces.sqrt(d2 + 1e-12)
    u = torch.clamp(su * inv_rc, max=1.0)
    taper = u * u * u * (10.0 + u * (6.0 * u - 15.0))
    one_u = 1.0 - u
    dtaper = torch.where(u < 1.0, 30.0 * u * u * one_u * one_u
                         * (0.5 / su) * inv_rc, 0.0)
    h = exact3 - taper * smooth3
    s = gx * dx + gy * dy
    ps = s * gm
    te = -1.5 * exact3 * ps / r2
    ts = -1.5 * smooth3 * ps / q2
    tt = dtaper * smooth3 * ps
    k2 = 2.0 * (te - tt - taper * ts)
    w = gm * h
    inside = d2 < rc2
    return (torch.where(inside, w * gx + k2 * dx, 0.0),
            torch.where(inside, w * gy + k2 * dy, 0.0),
            torch.where(inside, te, 0.0),
            torch.where(inside, s * h, 0.0))


def _pp_vjp_blocks(tb, gb, sb, rc, eps2, precise, cells_t, cells_s):
    """The block form of :func:`pp_cells_vjp_plain`: target blocks ``tb``
    (gc², cap_t, 3: x, y, r + floor), their cotangents ``gb`` (gc², cap_t,
    2, zero in empty slots) and source blocks ``sb`` (gc², cap_s, 3: x, y,
    gm, gm = 0 in empty slots). Returns the target slots' (gc², cap_t, 3)
    and the source slots' (gc², cap_s, 3) cotangents, computed for the
    target cells ``cells_t`` and the source cells ``cells_s`` only (zero
    elsewhere), a chunk of cells at a time: each target against its 3×3
    neighbour cells' sources, then each source against its neighbour
    cells' targets (the neighbourhood is symmetric, so each pair is seen
    once on each side)."""
    n_cells, cap_t, _ = tb.shape
    cap_s = sb.shape[1]
    gc = math.isqrt(n_cells)
    rc, eps2, inv_rc = _scalars(rc, eps2, tb.device)
    rc2 = rc * rc

    def ring(a, fill):
        """(gc + 2)² cells of the slots' values, a ring of ``fill``."""
        grid = a.reshape(gc, gc, -1)
        return torch.nn.functional.pad(grid, (0, 0, 1, 1, 1, 1),
                                       value=fill).reshape((gc + 2) ** 2, -1)

    def neighbours(padded, chunk):
        nb = _neighbour_cells(chunk, gc)
        return padded[nb].reshape(len(chunk), -1)

    out_t = torch.zeros((n_cells, cap_t, 3), dtype=DTYPE, device=tb.device)
    out_s = torch.zeros((n_cells, cap_s, 3), dtype=DTYPE, device=tb.device)
    per = max(1, PLAIN_CHUNK_ELEMS // (max(cap_t, cap_s) * 9
                                       * max(cap_t, cap_s)))
    src_ring = [ring(sb[..., k], 0.0) for k in range(3)]
    tgt_ring = [ring(tb[..., 0], 0.0), ring(tb[..., 1], 0.0),
                ring(tb[..., 2], 1.0), ring(gb[..., 0], 0.0),
                ring(gb[..., 1], 0.0)]
    for c0 in range(0, cells_t.shape[0], per):
        # targets of the chunk's cells against their neighbours' sources
        chunk = cells_t[c0:c0 + per]
        nsx, nsy, nsg = (neighbours(p, chunk)[:, None, :] for p in src_ring)
        tx, ty, tr = (tb[chunk, :, k][:, :, None] for k in range(3))
        gx, gy = (gb[chunk, :, k][:, :, None] for k in range(2))
        cx, cy, e_tr, _ = _pair_vjp_terms(nsx - tx, nsy - ty, tr, nsg, gx, gy,
                                          rc2, eps2, inv_rc, precise)
        out_t[chunk] = torch.stack([-cx.sum(-1), -cy.sum(-1), e_tr.sum(-1)],
                                   -1)
    for c0 in range(0, cells_s.shape[0], per):
        # sources of the chunk's cells against their neighbours' targets
        chunk = cells_s[c0:c0 + per]
        ntx, nty, ntr, ngx, ngy = (neighbours(p, chunk)[:, None, :]
                                   for p in tgt_ring)
        sx, sy, sg = (sb[chunk, :, k][:, :, None] for k in range(3))
        cx, cy, _, e_gm = _pair_vjp_terms(sx - ntx, sy - nty, ntr, sg, ngx,
                                          ngy, rc2, eps2, inv_rc, precise)
        out_s[chunk] = torch.stack([cx.sum(-1), cy.sum(-1), e_gm.sum(-1)], -1)
    return out_t, out_s


def pp_cells_vjp_plain(trows, srows, start_t, counts_t, start_s, counts_s, rc,
                       eps2, g, *, cap_t: int, cap_s: int,
                       precise: bool = False, cells=None):
    """Plain version of :func:`pp_cells_vjp`: the runs packed into blocks as
    :func:`pp_cells_plain` packs them (the cotangent ``g`` with them, zero
    in empty slots), the explicit VJP of the block correction on them, and
    the live slots' cotangents taken back to their rows. Only cells that
    hold rows are computed, and the blocks are cut to the fullest cell's
    slots (an empty slot adds exactly 0), which reads the counts on the
    host. With ``cells`` (cell indices) only the rows of those cells,
    targets and sources, are computed; the others stay 0 (a judge for a
    part of a large grid)."""
    n_t, n_s = trows.shape[0], srows.shape[0]
    with torch.no_grad():
        cap_t = max(1, min(cap_t, int(counts_t.max())))
        cap_s = max(1, min(cap_s, int(counts_s.max())))
        tb, idx_t, live_t = _runs_to_blocks(trows, start_t, counts_t, cap_t,
                                            (0.0, 0.0, 1.0, 0.0))
        g4 = torch.cat([g, torch.zeros_like(g)], 1)
        gb, _, _ = _runs_to_blocks(g4, start_t, counts_t, cap_t,
                                   (0.0, 0.0, 0.0, 0.0))
        sb, idx_s, live_s = _runs_to_blocks(srows, start_s, counts_s, cap_s,
                                            (0.0, 0.0, 0.0, 0.0))
        keep = torch.ones_like(counts_t, dtype=torch.bool)
        if cells is not None:
            keep = torch.zeros_like(keep)
            keep[cells] = True
        cells_t = torch.nonzero(keep & (counts_t > 0)).reshape(-1)
        cells_s = torch.nonzero(keep & (counts_s > 0)).reshape(-1)
        out_t, out_s = _pp_vjp_blocks(tb[..., :3], gb[..., :2], sb[..., :3],
                                      rc, eps2, precise, cells_t, cells_s)
        d_t = torch.zeros((n_t, 4), dtype=DTYPE, device=trows.device)
        d_s = torch.zeros((n_s, 4), dtype=DTYPE, device=trows.device)
        d_t[idx_t[live_t], :3] = out_t[live_t]
        d_s[idx_s[live_s], :3] = out_s[live_s]
    return d_t, d_s


class VjpPlan(NamedTuple):
    """How the VJP kernel cuts its work: each target cell's neighbourhood
    (its 3×3 cells' first cap_s sources, in neighbour order) into ranges
    of at most ``rows`` rows, one task a range; and the rows of both sides
    into tiles of TILE rows for the sums of the partials."""
    ranges: torch.Tensor  # (gc²,) int32 ranges of each cell, 0 without targets
    ends: torch.Tensor    # (4 gc²,) int32 one prefix sum over four lists
    rows: int             # R
    k_max: int            # the most ranges a cell can have, ceil(9 cap_s / R)


def _neighbourhood(live: torch.Tensor, gc: int) -> torch.Tensor:
    """(gc²,) the sum of ``live`` (gc²,) over each cell's 3×3 neighbours
    inside the grid."""
    p = torch.nn.functional.pad(live.reshape(1, gc, gc), (1, 1, 1, 1))[0]
    band = p[:-2] + p[1:-1] + p[2:]
    return (band[:, :-2] + band[:, 1:-1] + band[:, 2:]).reshape(-1)


def vjp_plan(counts_t: torch.Tensor, counts_s: torch.Tensor, gc: int,
             cap_t: int, cap_s: int, rows: int | None = None) -> VjpPlan:
    """The VJP kernel's plan, on the counts' device with no host sync, from
    the counts, caps and R alone (so a recomputed backward repeats its
    bits). A cell with live targets has ceil(L / R) ranges, L its
    neighbourhood's live sources. ``ends`` is the inclusive prefix sum,
    over the cells, of four lists one after the other: the ranges of the
    cells of at least VJP_HEAVY_TILES tiles (their tasks are the longest,
    so they are taken first), the ranges of the others (task k of the pass
    is range k - (the cell's end - its ranges) of the cell whose end is the
    first past k), then the sums' tiles: each cell's source tiles, and the
    target tiles of the cells of more than one range."""
    rows = VJP_RANGE if rows is None else rows
    live_s = counts_s.clamp(max=cap_s)
    tiles = (torch.stack([live_s, counts_t.clamp(max=cap_t)]) + (TILE - 1)) \
        // TILE
    ranges = (_neighbourhood(live_s, gc) + (rows - 1)) // rows * (tiles[1] > 0)
    heavy = ranges * (tiles[1] >= VJP_HEAVY_TILES)
    ends = torch.cumsum(torch.cat([heavy, ranges - heavy, tiles[0],
                                   tiles[1] * (ranges > 1)]), 0,
                        dtype=torch.int32)
    return VjpPlan(ranges, ends, rows, -(-9 * cap_s // rows))


def vjp_scratch_bytes(n_t: int, n_s: int, plan: VjpPlan) -> int:
    """Bytes of the VJP kernel's partials: 3 floats a (target row, range
    past the first) and a (source row, neighbour target cell)."""
    return 4 * 3 * ((plan.k_max - 1) * n_t + 9 * n_s)


def _plan_lists(plan: VjpPlan) -> list:
    """The plan's four lists as [(cell, first id, end id)] of the cells
    that hold ids, read on the host."""
    ends = plan.ends.tolist()
    n = len(ends) // 4
    out = []
    for k in range(4):
        prev = ends[k * n - 1] if k else 0
        cells = []
        for c in range(n):
            if ends[k * n + c] > prev:
                cells.append((c, prev, ends[k * n + c]))
            prev = ends[k * n + c]
        out.append(cells)
    return out


def vjp_tasks(plan: VjpPlan, counts_s: torch.Tensor, gc: int, cap_s: int):
    """The tasks of the pass in their order, as the kernel decodes them:
    (cell, range, spans), with spans the (source cell, first, end, slot)
    runs of the range's rows (rows first .. end - 1 of the source cell's
    run) and slot the place of the target cell among the source cell's
    3×3 neighbours, where those rows' partials go. Reads the plan on the
    host (for tests)."""
    live_s = counts_s.clamp(max=cap_s).tolist()
    lists = _plan_lists(plan)
    out = []
    for cell, lo, hi in lists[0] + lists[1]:
        ci, cj = divmod(cell, gc)
        for r in range(hi - lo):
            first, end = r * plan.rows, (r + 1) * plan.rows
            at, spans = 0, []
            for k in range(9):
                ni, nj = ci + k // 3 - 1, cj + k % 3 - 1
                if not (0 <= ni < gc and 0 <= nj < gc):
                    continue
                nc = ni * gc + nj
                a, b = max(first, at), min(end, at + live_s[nc])
                if a < b:
                    spans.append((nc, a - at, b - at, 8 - k))
                at += live_s[nc]
            out.append((cell, r, spans))
    return out


def vjp_sum_tiles(plan: VjpPlan):
    """The tiles of the partials' sums, as the kernel decodes them:
    ("sources" | "targets", cell, first slot) for each tile of 32 slots of
    a cell (its source slots, or its target slots where the cell has more
    than one range). Reads the plan on the host (for tests)."""
    lists = _plan_lists(plan)
    return [(side, cell, k * TILE)
            for side, cells in (("sources", lists[2]), ("targets", lists[3]))
            for cell, lo, hi in cells for k in range(hi - lo)]


def pp_cells_vjp(
    trows: torch.Tensor, srows: torch.Tensor,
    start_t: torch.Tensor, counts_t: torch.Tensor,
    start_s: torch.Tensor, counts_s: torch.Tensor,
    rc: float | torch.Tensor, eps2: float | torch.Tensor,
    g: torch.Tensor,         # (n_t, 2) cotangent of pp_cells' result
    *, cap_t: int, cap_s: int, precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of :func:`pp_cells` at its rows with cotangent ``g``:
    (d_trows (n_t, 4), d_srows (n_s, 4)), columns x, y and r + floor (gm
    for the sources), column 3 zero. Rows past a cell's cap (either side)
    get exactly 0, as the slots that ``nbody_tpu``'s packed blocks drop.

    On the card: ``csrc/p3m_pp_vjp.cu``, one pass over the pairs cut as
    :func:`vjp_plan` says (a block a range of a target cell's
    neighbourhood, its tiles' targets in registers) and the fixed-order
    sums of its partials: no atomics on floats, no host sync. On the CPU:
    :func:`pp_cells_vjp_plain`."""
    device = trows.device
    _check_device(device)
    runs = {"start_t": start_t, "counts_t": counts_t, "start_s": start_s,
            "counts_s": counts_s}
    gc = _check_cells(trows, srows, runs, cap_t, cap_s, device)
    _check_float("g", g, (trows.shape[0], 2), device)
    rc, eps2 = _no_grad_scalar(rc), _no_grad_scalar(eps2)
    if device.type == "cpu":
        return pp_cells_vjp_plain(trows, srows, start_t, counts_t, start_s,
                                  counts_s, rc, eps2, g, cap_t=cap_t,
                                  cap_s=cap_s, precise=precise)
    global VJP_LAUNCHES
    from . import _build

    n_t, n_s = trows.shape[0], srows.shape[0]
    plan = vjp_plan(counts_t, counts_s, gc, cap_t, cap_s)
    # partial keys (< 9 n_s) and tasks (< gc² k_max) are int32
    _check_kernel_rows(trows, srows, max(9 * n_s, gc * gc * plan.k_max))
    d_t = torch.zeros((n_t, 4), dtype=DTYPE, device=device)
    d_s = torch.zeros((n_s, 4), dtype=DTYPE, device=device)
    if n_t == 0 or n_s == 0:
        return d_t, d_s
    part_t = torch.empty((plan.k_max - 1) * 3 * n_t, dtype=DTYPE,
                         device=device)
    part_s = torch.empty(27 * n_s, dtype=DTYPE, device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    scal = _scalars(rc, eps2, device)
    with torch.cuda.device(device):
        err = _build.load("p3m_pp_vjp").nbody_p3m_pp_vjp(
            trows.data_ptr(), n_t, srows.data_ptr(), n_s, start_t.data_ptr(),
            counts_t.data_ptr(), start_s.data_ptr(), counts_s.data_ptr(), gc,
            cap_t, cap_s, scal.data_ptr(), int(precise), g.data_ptr(),
            plan.ranges.data_ptr(), plan.ends.data_ptr(), plan.rows,
            counter.data_ptr(), part_t.data_ptr(), part_s.data_ptr(),
            d_t.data_ptr(), d_s.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"p3m_pp_vjp kernel launch failed: cudaError {err}")
    VJP_LAUNCHES += 1
    return d_t, d_s


def pp_blocks(
    tx: torch.Tensor, ty: torch.Tensor, tr: torch.Tensor,  # (gc, gc, cap_t)
    sx: torch.Tensor, sy: torch.Tensor, sg: torch.Tensor,  # (gc, gc, cap_s)
    rc: float | torch.Tensor, eps2: float | torch.Tensor, *,
    precise: bool = False,
    counts_t: torch.Tensor | None = None,   # (gc²,) int32 targets per cell
    counts_s: torch.Tensor | None = None,   # (gc²,) int32 sources per cell
) -> torch.Tensor:
    """Per-slot P³M pair correction of packed target cell blocks against
    packed source cell blocks: (gc², cap_t, 2) fp32. Adds SOFTENING_FLOOR to
    ``tr`` as ``nbody_tpu``'s ``pp_blocks`` does. The call makes no host
    sync.

    Without the counts every slot is computed (the JAX ``pp_blocks``
    semantics). With ``counts_t``, slots at or beyond a cell's count are
    zero; with ``counts_s``, only a cell's first ``counts_s`` source slots
    are read (the others must hold gm = 0, as packed blocks do)."""
    device = tx.device
    _check_device(device)
    _check_blocks(((tx, ty, tr), (sx, sy, sg)),
                  {"counts_t": counts_t, "counts_s": counts_s}, device)
    if device.type == "cpu":
        return pp_blocks_plain(tx, ty, tr, sx, sy, sg, rc, eps2,
                               precise=precise, counts_t=counts_t,
                               counts_s=counts_s)
    gc, _, cap_t = tx.shape
    cap_s = sx.shape[-1]
    cells = torch.arange(gc * gc, dtype=torch.int32, device=device)

    def runs(counts, cap):
        full = torch.full_like(cells, cap) if counts is None else counts
        return cells * cap, full

    trows = torch.stack([tx, ty, tr + SOFTENING_FLOOR, torch.zeros_like(tx)],
                        -1).reshape(-1, 4)
    srows = torch.stack([sx, sy, sg, torch.zeros_like(sx)], -1).reshape(-1, 4)
    out = _launch(trows, srows, *runs(counts_t, cap_t), *runs(counts_s, cap_s),
                  gc, cap_t, cap_s, rc, eps2, precise)
    return out.reshape(gc * gc, cap_t, 2)
