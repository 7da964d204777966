"""Force only with Newton's third law over the massive prefix (K5h): the
CUDA kernel's wrapper, its task plan and its plain PyTorch version.

Counterpart of ``make_newton(tile_t, mass_len, s, fchunk)`` in
``scripts/ablations/tune_r2h.py``; the kernel is
``csrc/newton_forces.cu``. Targets are (4, T) rows x; y; r; gm and sources
(4, S) rows x; y; gm; r, whose first M = mass_len rows are the same
particles (the massive prefix of a world). With tile width W and
m_full = M // W whole massive tiles, the work of a target tile is a list
of items:

  * massive tile I < m_full: "fwd" over its own tile, a "dual" block with
    every tile J in (I, m_full) (forward on I, reverse on J from the same
    dx, dy, d²), then "fwd" over the tail [m_full W, S) in pieces of W;
  * every other tile: "run" e, forward over [eW, (e+1)W) of [0, S).

:func:`newton_schedule` cuts each tile's items into tasks of
:func:`group` items, heaviest first (one CUDA block a task, its
:func:`teams` teams taking every teams-th item). Each massive task's
forward sum (its teams' sums added in team order) has a slot of its own;
each run has its own. A massive row adds its slots in order, then the
reverse sums that tiles I' < I left for it in order of I'; another row
adds its runs in order, each run summed on its own: the association the
rows had before the task list. Every (target, source) pair is counted
once at every M, W and T; the TPU kernel is not (ROADMAP). CPU tensors
take the plain version, which follows the same items, teams, slots and
sums; CUDA tensors launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import forces
from ..types import SOFTENING_FLOOR
from .direct_forces import _check, _device_of, _raise_on

TILES = (128, 256, 512)
THREADS = 256       # csrc/newton_forces.cu kThreads: a block a task
TEAM_SOURCES = 512  # sources a team walks in a task (one item at least)
# A dual source step's SASS over a forward one's (two targets a thread:
# about 39 against 23), for ordering the tasks.
DUAL_COST = 1.7

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


class Task(NamedTuple):
    """A block's work: target tile ``tile``, its items ``first``,
    ``first + 1``, ... (``items``, each (kind, lo, hi)); a massive task's
    forward sum goes to slot ``first // group(W)`` of its tile."""

    tile: int
    first: int
    items: tuple


def _lib():
    from . import _build

    return _build.load("newton_forces")


def teams(tile: int) -> int:
    """Teams of a block: tile // 2 threads each, two targets a thread."""
    return THREADS // (tile // 2)


def group(tile: int) -> int:
    """Items a task: TEAM_SOURCES sources (at least one item) a team."""
    return teams(tile) * max(1, TEAM_SOURCES // tile)


def smem_bytes(tile: int) -> int:
    """Shared memory of a block: each team's two stages (a dual tile, W
    sources as four floats, twice) and its warps' reverse sums of a dual
    tile (W float2 a warp)."""
    return teams(tile) * (2 * 8 * tile + tile // 64 * tile * 2) * 4


def tile_items(i: int, m_full: int, s: int, w: int) -> list:
    """The items (kind, lo, hi) of target tile i, in item order."""
    if i < m_full:
        return ([("fwd", i * w, (i + 1) * w)]
                + [("dual", j * w, (j + 1) * w) for j in range(i + 1, m_full)]
                + [("fwd", lo, min(lo + w, s)) for lo in range(m_full * w, s, w)])
    return [("run", lo, min(lo + w, s)) for lo in range(0, s, w)]


def task_cost(task: Task, tile: int) -> float:
    """The longest team's source steps, a dual step counted DUAL_COST."""
    k = teams(tile)
    return max(sum((DUAL_COST if kind == "dual" else 1.0) * (hi - lo)
                   for kind, lo, hi in task.items[team::k])
               for team in range(min(k, len(task.items))))


def newton_schedule(t: int, mass_len: int, s: int, tile: int) -> list:
    """The kernel's tasks in launch order: every tile's items cut into
    tasks of :func:`group` items, sorted by :func:`task_cost`, heaviest
    first (ties in tile order)."""
    m_full, g = mass_len // tile, group(tile)
    tasks = []
    for i in range(-(-t // tile)):
        items = tile_items(i, m_full, s, tile)
        tasks += [Task(i, e0, tuple(items[e0:e0 + g]))
                  for e0 in range(0, len(items), g)]
    return sorted(tasks, key=lambda task: task_cost(task, tile), reverse=True)


def newton_plan(t: int, mass_len: int, s: int, tile: int) -> torch.Tensor:
    """(tasks, 2) int32 rows (tile, first item) of :func:`newton_schedule`:
    the kernel's plan (a task's items and slot follow from them)."""
    return torch.tensor([[k.tile, k.first]
                         for k in newton_schedule(t, mass_len, s, tile)],
                        dtype=torch.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=32)
def _device_plan(t: int, mass_len: int, s: int, tile: int,
                 device: torch.device) -> torch.Tensor:
    return newton_plan(t, mass_len, s, tile).to(device)


def scratch_sizes(t: int, mass_len: int, s: int, tile: int) -> dict:
    """float2 elements of the kernel's scratch: R, the reverse sums
    (m_full, m_full W) when m_full >= 2; F, the massive slots (the most
    slots of a tile, m_full W); P, the runs of the other rows (runs, T -
    m_full W)."""
    m_full = mass_len // tile
    mw = m_full * tile
    n_tail, n_runs = -(-(s - mw) // tile), -(-s // tile)
    return {"R": m_full * mw if m_full >= 2 else 0,
            "F": -(-(m_full + n_tail) // group(tile)) * mw if m_full else 0,
            "P": n_runs * (t - mw)}


def newton_pairs(t: int, mass_len: int, s: int, tile: int) -> tuple[int, int]:
    """(forward pairs, dual pairs) of the schedule: each dual pair is two
    interactions, so forward + 2 * dual = T * S."""
    m_full = mass_len // tile
    dual = m_full * (m_full - 1) // 2 * tile * tile
    return t * s - 2 * dual, dual


def _check_args(t: int, s: int, mass_len: int, tile: int) -> None:
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if not 0 <= mass_len <= min(s, t):
        raise ValueError(f"mass_len must be in [0, min(S, T)] = [0, "
                         f"{min(s, t)}], got {mass_len}")


def newton_acc_plain(tgt, src, mass_len: int, *, tile: int = 256):
    """Plain version of :func:`newton_acc`: each item's sums, then each
    task of :func:`newton_schedule` adds a massive tile's items team by
    team in item order and the teams in team order into its slot; a
    massive row adds its slots in order, then the reverse sums of the tiles
    before it in order of the tile; every other row adds its runs in order,
    each run a direct sum of its own."""
    t, s = tgt.shape[-1], src.shape[-1]
    _check_args(t, s, mass_len, tile)
    m_full, w, k = mass_len // tile, tile, teams(tile)
    mw = m_full * w
    tpos, tr, tgm = tgt[:2].T, tgt[2], tgt[3]
    spos, sgm = src[:2].T, src[2]
    soft_s = src[3] + SOFTENING_FLOOR
    out = torch.zeros((t, 2), dtype=torch.float32, device=tgt.device)

    def fwd(rows, lo, hi):
        return forces.direct_sum_acc(tpos[rows], tr[rows], spos[lo:hi],
                                     sgm[lo:hi], precise=False)

    rest = slice(mw, t)
    if mw < t:
        for lo in range(0, s, w):   # the runs, in order
            out[rest] += fwd(rest, lo, min(lo + w, s))
    rev = torch.zeros((m_full, mw, 2), dtype=torch.float32, device=tgt.device)
    g = group(tile)
    item_sums = []   # of each massive tile: (items padded to whole tasks, W, 2)
    for i in range(m_full):
        rows = slice(i * w, (i + 1) * w)
        items = tile_items(i, m_full, s, w)
        sums = [fwd(rows, lo, hi) for kind, lo, hi in items if kind == "fwd"]
        if i + 1 < m_full:   # the dual items, tiles J = i + 1 ... in order
            cols = slice((i + 1) * w, mw)
            dx = spos[cols, 0][None, :] - tpos[rows, 0][:, None]
            dy = spos[cols, 1][None, :] - tpos[rows, 1][:, None]
            d2 = dx * dx + dy * dy
            inv = torch.rsqrt(d2 + (tr[rows] + SOFTENING_FLOOR)[:, None])
            f = sgm[cols][None, :] * (inv * inv * inv)
            dual = torch.stack([(dx * f).reshape(w, -1, w).sum(2),
                                (dy * f).reshape(w, -1, w).sum(2)], -1)
            sums[1:1] = dual.unbind(1)
            inv = torch.rsqrt(d2 + soft_s[cols][None, :])
            fr = tgm[rows][:, None] * (inv * inv * inv)
            rev[i, cols] = torch.stack([-(dx * fr).sum(0), -(dy * fr).sum(0)],
                                       -1)
        sums += [torch.zeros_like(sums[0])] * (-len(sums) % g)
        item_sums.append(torch.stack(sums))
    slots = [[] for _ in range(m_full)]
    for task in newton_schedule(t, mass_len, s, tile):
        if task.tile >= m_full:
            continue
        # (items a team, teams, W, 2): item first + a * k + team is team's
        items = item_sums[task.tile][task.first:task.first + g].reshape(
            g // k, k, w, 2)
        teams_sum = functools.reduce(torch.add, items.unbind(0))
        slots[task.tile].append(
            (task.first, functools.reduce(torch.add, teams_sum.unbind(0))))
    for i in range(m_full):
        for _, part in sorted(slots[i], key=lambda sp: sp[0]):
            out[i * w:(i + 1) * w] += part
    for i in range(m_full - 1):   # in order of the tile that made them
        out[(i + 1) * w:mw] += rev[i, (i + 1) * w:]
    return out[:, 0][None], out[:, 1][None]


def newton_acc(
    tgt: torch.Tensor,   # (4, T) rows x; y; r; gm
    src: torch.Tensor,   # (4, S) rows x; y; gm; r
    mass_len: int,
    *,
    tile: int = 256,
):
    """(ax, ay), each (1, T) fp32, rsqrt path, with each massive x massive
    tile pair computed once. The first ``mass_len`` rows of ``tgt`` and
    ``src`` must be the same particles. Two launches on the card (the
    tasks, then the fixed-order sums), counted as one."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (4, t), device)
    _check("src", src, (4, s), device)
    _check_args(t, s, mass_len, tile)
    if device.type == "cpu":
        return newton_acc_plain(tgt, src, mass_len, tile=tile)
    global LAUNCHES
    plan = _device_plan(t, mass_len, s, tile, device)
    n_scratch = sum(scratch_sizes(t, mass_len, s, tile).values())
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    scratch = torch.empty((max(n_scratch, 1), 2), dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_newton_forces(
            tgt.data_ptr(), src.data_ptr(), t, s, mass_len, tile,
            plan.data_ptr(), plan.shape[0], group(tile), scratch.data_ptr(),
            n_scratch, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "newton_forces")
    LAUNCHES += 1
    return out[0:1], out[1:2]
