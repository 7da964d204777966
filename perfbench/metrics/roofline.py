"""The yardstick of the kernels' roofline shares: the card's published
peaks, and each kernel's operations and bytes computed from its shapes and
from what these inputs need.

A share is the least time the card could take over the kernel's measured
device time. The least time is the larger of the fp32 operations over the
fp32 peak and the bytes over the memory bandwidth: the work is counted by
the algorithm, whatever implements it, so no term depends on how a kernel
computes its square roots. Each input byte is counted read once and each
output byte written once.
"""

from __future__ import annotations

from ..reference import p3m

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations a pair, a transcendental counted as one: the direct
# force as the TPU kernel counts it (nbody_tpu/ops/pallas_forces.py:380),
# the P³M correction as p3m_pallas.py:120-125 does.
FLOPS_DIRECT = 13
FLOPS_PP = 14


def least_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def direct_substep(n: int, s: int) -> tuple[float, float]:
    """(operations, bytes) of one fused direct substep: every row against
    the s massive rows; pos, vel, radius of the n rows and the s gm read,
    acc, pos and vel of the n rows written."""
    return FLOPS_DIRECT * n * s, 44.0 * n + 4.0 * s


def pair_count(pos, gm, cfg: dict) -> dict:
    """What the P³M pair kernel has to do at these positions: kept target
    and source rows, cells, and the candidate pairs inside rc (d² < rc² in
    float32), counted on the reference's cells."""
    sim = cfg["sim"]
    grid, cap = sim["pm_grid"], sim["p3m_cell_capacity"]
    lo, h = p3m.box(pos, grid)
    rc = sim["p3m_rc_cells"] * h
    cid, gc = p3m.cells(pos, lo, h, grid, sim["p3m_rc_cells"])
    blocks = p3m.pair_blocks(pos, cid, cid[:gm.shape[0]], gm, gc, cap)
    tgt, tc, order_s, start_s, live_s, spans = blocks
    inside = 0
    rc2 = rc * rc
    for t0, t1 in spans:
        ti, si = p3m.candidates(tc, order_s, start_s, live_s, gc, t0, t1)
        rows = tgt[ti]
        dx = pos[si, 0] - pos[rows, 0]
        dy = pos[si, 1] - pos[rows, 1]
        inside += int((dx * dx + dy * dy < rc2).sum())
    return {"live_t": int(tgt.shape[0]), "live_s": int(live_s.sum()),
            "cells": gc * gc, "n_t": int(pos.shape[0]), "inside": inside}


def pair_substep(c: dict) -> tuple[float, float]:
    """(operations, bytes) of one pair-kernel launch: 14 operations a pair
    inside rc; the kept rows (16 bytes each) and the four run arrays (4
    bytes a cell each) read once, one (x, y) written a target row."""
    nbytes = 16.0 * (c["live_t"] + c["live_s"]) + 16.0 * c["cells"] + 8.0 * c["n_t"]
    return FLOPS_PP * c["inside"], nbytes


def share(ctx, kernel: str, flops: float, nbytes: float, label: str):
    """The roofline share in % of the traced window's ``kernel`` launches,
    each of which did ``flops`` and ``nbytes``; None where the window holds
    none of them."""
    if ctx.window is None:
        return None
    seconds, launches = ctx.window.kernel_s(kernel)
    if not launches or seconds <= 0:
        return None
    least, by = least_s(flops, nbytes)
    pct = 100.0 * least * launches / seconds
    ctx.log(f"{label}: {pct!r} % ({launches} launches in {ctx.window.substeps} "
            f"substeps, {seconds / launches * 1e3!r} ms each, least "
            f"{least * 1e3!r} ms by {by}; {ctx.power})")
    return pct


def traced_pair_counts(ctx) -> dict | None:
    """The pair kernel's counts, the mean of the states before and after
    the traced window."""
    if not ctx.traced_pos:
        return None
    counts = [pair_count(p, ctx.gm, ctx.config) for p in ctx.traced_pos]
    return {k: sum(c[k] for c in counts) / len(counts) for k in counts[0]}
