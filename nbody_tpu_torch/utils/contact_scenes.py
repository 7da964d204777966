"""Scenes that test the contact search's grid where it is tight
(``ops/collisions.contact_grid``): the kernel and its plain versions must
agree bit for bit on each. Made with numpy from a seed, on any device.

    all_in_one_cell  3000 rows inside one cell: every row meets every row
    fewer_than_k     20 live rows, fewer than the big rows (all big)
    cell_edges       rows exactly on the cells' edges, each with a partner
                     just inside reach across the edge
    at_reach         pairs at exactly reach (no contact: d2 < reach² is
                     strict), one ulp inside it, and diagonal pairs, near
                     the origin and near x = 1e6
    far_and_big      clusters near 1e6 with a few rows of large radius
                     (as the galaxy cores) among rows of small radius
    tight_margin     pairs one ulp inside reach whose first row lies just
                     below a cell's edge, built for the grid's own width:
                     a cell width below reach (a margin under 1) loses
                     them (``tight_margin_scene``)
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("all_in_one_cell", "fewer_than_k", "cell_edges", "at_reach",
         "far_and_big", "tight_margin")


def _tensors(pos, radius, mass, live, device):
    out = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
           for a in (pos, radius, mass)]
    return (*out, torch.from_numpy(np.asarray(live, bool)).to(device))


def contact_scene(kind: str, device="cpu", seed: int = 5) -> tuple:
    """(pos (M, 2), radius (M,), mass (M,) fp32, live (M,) bool) of one of
    KINDS, for factor 1 (and any other factor)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if kind == "all_in_one_cell":
        n = 3000
        pos = rng.uniform(0.0, 0.9, (n, 2))       # a cell is > 1.0 wide
        radius = np.full(n, 0.5)
        mass = np.round(rng.uniform(0.5, 2.0, n) * 4) / 4
    elif kind == "fewer_than_k":
        n = 20
        pos = rng.uniform(-3.0, 3.0, (n, 2))
        radius = rng.uniform(0.2, 1.5, n)
        mass = np.round(rng.uniform(0.5, 2.0, n) * 2) / 2
    elif kind == "cell_edges":
        # r = 0.5 everywhere: reach R = 1.0 and cells w = R (1 + 2^-8)
        # wide from the row at (0, 0); anchors on the edges k·w, partners
        # one ulp inside reach on the other side of an edge
        w = 1.0 * (1.0 + 2.0 ** -8)
        k = np.arange(24)
        ax, ay = np.meshgrid(k * w, k * w)
        anchors = np.stack([ax.ravel(), ay.ravel()], 1).astype(f32)
        inside = np.nextafter(f32(1.0), f32(0.0))
        axis = rng.integers(0, 2, len(anchors))
        at = anchors[np.arange(len(anchors)), axis]
        # across the edge (into the cell before), or into the anchor's own
        # cell where there is none before (the origin stays at 0)
        step = np.where((rng.uniform(size=len(anchors)) < 0.7) & (at > 0),
                        -inside, inside)
        partners = anchors.astype(np.float64).copy()
        partners[np.arange(len(anchors)), axis] += step
        pos = np.concatenate([anchors, partners])
        n = len(pos)
        radius = np.full(n, 0.5)
        mass = rng.uniform(0.5, 2.0, n)
    elif kind == "at_reach":
        rows = []
        for x0 in (0.0, 1e6):
            for k in range(200):
                a = np.array([x0 + 4.0 * k, 3.0 * (k % 7) * (k % 3 != 1)])
                d = [np.array([1.0, 0.0]),                    # exactly reach
                     np.array([0.0, float(np.nextafter(f32(1.0), f32(0.0)))]),
                     np.array([0.6, 0.8])][k % 3]             # d2 rounds
                rows += [a, a + d]
        pos = np.array(rows)
        n = len(pos)
        radius = np.full(n, 0.5)
        mass = np.round(rng.uniform(0.5, 2.0, n) * 2) / 2
    elif kind == "far_and_big":
        n = 4000
        centres = 1e6 + rng.uniform(-50.0, 50.0, (4, 2))
        pos = centres[rng.integers(0, 4, n)] + rng.normal(0.0, 6.0, (n, 2))
        radius = rng.uniform(0.05, 0.45, n)
        radius[:6] = [287.4, 528.4, 3.0, 9.5, 9.5, 2.0]
        mass = rng.uniform(0.5, 2.0, n)
        mass[:2] = 1e4
    elif kind == "tight_margin":
        return tight_margin_scene(device=device)
    else:
        raise ValueError(f"unknown scene {kind!r}; one of {KINDS}")
    live = rng.uniform(size=n) > 0.05
    live[0] = True
    return _tensors(pos, radius, mass, live, device)


def tight_margin_scene(margin: float | None = None, device="cpu",
                       big_rows: int | None = None) -> tuple:
    """The "tight_margin" scene for cells ``margin`` times reach wide (the
    grid's CELL_MARGIN by default), factor 1. ``big_rows`` (K) rows of
    radius 0.5 lie far away, so the K-th largest radius is r_cut = 0.5 and
    reach R = 1.0; every other row has radius 0.5 − 2^-25, so its pairs
    reach one ulp less. A
    row at (0, 0) fixes the origin; on rows y = 3k, k = 1 … 7, a row at
    the largest fp32 below the edge k·w, w = R · margin, and a partner at
    the largest fp32 x that the kernel's fp32 test still puts in contact
    with it: d < R, and with margin 1 − 2^-20, d > w."""
    from ..ops import collisions as col

    f32 = np.float32
    w = 1.0 * (col.CELL_MARGIN if margin is None else margin)
    k_big = col.BIG_ROWS if big_rows is None else big_rows
    small = np.nextafter(f32(0.5), f32(0.0))
    reach = f32(small + small)
    rows = [(0.0, 0.0)]
    for k in range(1, 8):
        x1 = f32(k * w)
        while float(x1) >= k * w:
            x1 = np.nextafter(x1, f32(-np.inf))
        x2 = f32(x1 + reach)
        while not f32(f32(x1 - x2) * f32(x1 - x2)) < f32(reach * reach):
            x2 = np.nextafter(x2, f32(-np.inf))
        rows += [(x1, 3.0 * k), (x2, 3.0 * k)]
    n = len(rows)
    far = np.stack([np.arange(k_big) * 10.0, np.full(k_big, 1e3)], 1)
    pos = np.concatenate([np.array(rows, np.float64), far])
    radius = np.concatenate([np.full(n, small), np.full(k_big, 0.5)])
    mass = np.ones(n + k_big)
    return _tensors(pos, radius, mass, np.ones(n + k_big, bool), device)
