"""Force only with Newton's third law over the massive prefix (K5h): the
CUDA kernel's wrapper, its schedule and its plain PyTorch version.

Counterpart of ``make_newton(tile_t, mass_len, s, fchunk)`` in
``scripts/ablations/tune_r2h.py``; the kernel is
``csrc/newton_forces.cu``. Targets are (4, T) rows x; y; r; gm and sources
(4, S) rows x; y; gm; r, whose first M = mass_len rows are the same
particles (the massive prefix of a world). With tile width W and
m_full = M // W whole massive tiles:

  * massive tile I < m_full: forward over its own tile, the dual block
    with every tile J in (I, m_full) (forward on I, reverse on J from the
    same dx, dy, d²), forward over the tail [m_full W, S), and the reverse
    sums of the tiles before it, added in order of I;
  * every other tile: forward over [0, S).

:func:`newton_schedule` lists that work block by block as the kernel runs
it (block b < ceil(m_full / 2) runs massive tiles b and m_full - 1 - b),
and the plain version walks the same schedule with the same reverse
scratch, so the CPU tests check the card's bookkeeping. Every (target,
source) pair is counted once at every M, W and T; the TPU kernel is not
(ROADMAP). CPU tensors take the plain version; CUDA tensors launch the
kernel, and anything wrong there raises.
"""

from __future__ import annotations

import torch

from .. import forces
from ..types import SOFTENING_FLOOR
from .direct_forces import _check, _device_of, _raise_on

TILES = (128, 256, 512)

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("newton_forces")


def _tile_work(i: int, m_full: int, s: int, w: int) -> list:
    """(kind, lo, hi) source ranges of massive tile i: "fwd" forward only,
    "dual" a dual block with source tile [lo, hi)."""
    return ([("fwd", i * w, (i + 1) * w)]
            + [("dual", j * w, (j + 1) * w) for j in range(i + 1, m_full)]
            + [("fwd", m_full * w, s)])


def newton_schedule(t: int, mass_len: int, s: int, tile: int) -> list:
    """The kernel's work in launch order: one entry per CUDA block, a list
    of (target tile index, [(kind, lo, hi), ...]) in the order the block
    runs them."""
    m_full = mass_len // tile
    blocks = []
    for b in range((m_full + 1) // 2):
        tiles = [b] if m_full - 1 - b == b else [b, m_full - 1 - b]
        blocks.append([(i, _tile_work(i, m_full, s, tile)) for i in tiles])
    for i in range(m_full, -(-t // tile)):
        blocks.append([(i, [("fwd", 0, s)])])
    return blocks


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
    """Plain version of :func:`newton_acc`, walking
    :func:`newton_schedule`: each tile's forward sums, the dual blocks'
    reverse sums into an (m_full, m_full W, 2) scratch, then each massive
    row's reverse sums added in order of the tile that made them."""
    t, s = tgt.shape[-1], src.shape[-1]
    _check_args(t, s, mass_len, tile)
    m_full = mass_len // tile
    width = m_full * tile
    tpos, tr, tgm = tgt[:2].T, tgt[2], tgt[3]
    spos, sgm = src[:2].T, src[2]
    soft_s = src[3] + SOFTENING_FLOOR
    out = torch.zeros((2, t), dtype=torch.float32, device=tgt.device)
    rev = torch.zeros((m_full, width, 2), dtype=torch.float32, device=tgt.device)
    for block in newton_schedule(t, mass_len, s, tile):
        for i, work in block:
            rows = slice(i * tile, min((i + 1) * tile, t))
            acc = torch.zeros((rows.stop - rows.start, 2), dtype=torch.float32,
                              device=tgt.device)
            dual = [(lo, hi) for kind, lo, hi in work if kind == "dual"]
            for kind, lo, hi in work:
                if kind == "fwd" and hi > lo:
                    acc += forces.direct_sum_acc(tpos[rows], tr[rows],
                                                 spos[lo:hi], sgm[lo:hi],
                                                 precise=False)
            if dual:
                cols = slice(dual[0][0], dual[-1][1])
                dx = spos[cols, 0][None, :] - tpos[rows, 0][:, None]
                dy = spos[cols, 1][None, :] - tpos[rows, 1][:, None]
                d2 = dx * dx + dy * dy
                inv = torch.rsqrt(d2 + (tr[rows] + SOFTENING_FLOOR)[:, None])
                f = sgm[cols][None, :] * (inv * inv * inv)
                acc += torch.stack([(dx * f).sum(1), (dy * f).sum(1)], -1)
                inv = torch.rsqrt(d2 + soft_s[cols][None, :])
                fr = tgm[rows][:, None] * (inv * inv * inv)
                rev[i, cols] = torch.stack([-(dx * fr).sum(0),
                                            -(dy * fr).sum(0)], -1)
            out[:, rows] = acc.T
    for k in range(m_full - 1):   # in order of the tile that made them
        out[:, (k + 1) * tile:width] += rev[k, (k + 1) * tile:].T
    return out[0:1], out[1:2]


def newton_acc(
    tgt: torch.Tensor,   # (4, T) rows x; y; r; gm
    src: torch.Tensor,   # (4, S) rows x; y; gm; r
    mass_len: int,
    *,
    tile: int = 256,
):
    """(ax, ay), each (1, T) fp32, rsqrt path, with each massive x massive
    tile pair computed once. The first ``mass_len`` rows of ``tgt`` and
    ``src`` must be the same particles. Two launches on the card, counted
    as one."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (4, t), device)
    _check("src", src, (4, s), device)
    _check_args(t, s, mass_len, tile)
    if device.type == "cpu":
        return newton_acc_plain(tgt, src, mass_len, tile=tile)
    global LAUNCHES
    m_full = mass_len // tile
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    scratch = torch.empty((max(m_full, 1), max(m_full * tile, 1), 2),
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_newton_forces(
            tgt.data_ptr(), src.data_ptr(), t, s, mass_len, tile,
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "newton_forces")
    LAUNCHES += 1
    return out[0:1], out[1:2]
