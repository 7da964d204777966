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
  * the contact search, the pass's only O(M²) work over the M rows of the
    massive prefix: :func:`contacts` launches ``csrc/merge_contacts.cu`` on
    CUDA tensors and takes :func:`contacts_plain` on CPU tensors;
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

import torch

from .. import forces
from ..forces import add_at
from .direct_forces import _check, _device_of, _raise_on, device_sms

# Threads (targets) a block and sources a shared-memory tile of the kernel
# (csrc/merge_contacts.cu kBlock).
BLOCK = 256
# Blocks an SM of the card should hold for the search to fill it (8 x 256
# threads, the SM's limit of 2048).
BLOCKS_PER_SM = 8
# The absorbed row's radius: a standard tracer (galaxy.c:205-206).
TRACER_RADIUS = 0.5

# Kernel launches made by ``contacts`` in this process (plain-version calls
# are not counted). A run resets it to 0 and reads it back.
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("merge_contacts")


def contact_plan(m: int, sms: int) -> tuple[int, int]:
    """(n_split, tiles_per_split) of a launch over ``m`` prefix rows on a
    card of ``sms`` SMs: the sources are cut into ranges of whole
    256-source tiles, enough of them for about BLOCKS_PER_SM blocks per SM,
    with no range left empty."""
    tiles = -(-m // BLOCK)
    if tiles == 0:
        return 1, 1
    n = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), tiles, 65535))
    per = -(-tiles // n)
    return -(-tiles // per), per


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
        ti = idx[t]
        dx = pos[t, None, 0] - pos[None, :, 0]
        dy = pos[t, None, 1] - pos[None, :, 1]
        d2 = dx * dx + dy * dy
        reach = factor * (radius[t, None] + radius[None, :])
        tmass = mass[t, None]
        beats = (mass[None, :] > tmass) | ((mass[None, :] == tmass)
                                           & (idx[None, :] < ti[:, None]))
        contact = ((d2 < reach * reach) & live[t, None] & live[None, :]
                   & (ti[:, None] != idx[None, :]) & beats)
        # heaviest beating contact, ties to the lower index
        key = torch.where(contact, mass[None, :], float("-inf"))
        best = key.amax(dim=1)
        at_best = contact & (key == best[:, None])
        is_loser[t] = best > float("-inf")
        winner[t] = torch.where(at_best, idx[None, :], m).amin(dim=1)
    return is_loser, winner


def contacts(pos: torch.Tensor, radius: torch.Tensor, mass: torch.Tensor,
             live: torch.Tensor, factor: float, *, plan: tuple | None = None):
    """The contact search over the M rows of the massive prefix: returns
    (is_loser (M,) bool, winner (M,) int64). Row i is a loser when a live
    row j != i in contact (|p_i − p_j|² < (factor·(r_i + r_j))²) beats it
    (heavier, or as heavy with j < i); winner[i] is the heaviest such j,
    the lowest index among equals, and M where there is none. Dead rows
    (``live`` False) neither lose nor win.

    ``pos`` (M, 2), ``radius`` and ``mass`` (M,) fp32, ``live`` (M,) bool,
    all on one device. On CUDA tensors one launch of the kernel (with
    ``plan`` = (n_split, tiles_per_split) if given, else
    :func:`contact_plan`); on CPU tensors :func:`contacts_plain`."""
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
    n_split, per = (contact_plan(m, device_sms(device)) if plan is None
                    else plan)
    tiles = -(-m // BLOCK)
    if not (1 <= n_split <= 65535 and per >= 1 and n_split * per >= tiles
            and (n_split - 1) * per < tiles):
        raise ValueError(f"plan {(n_split, per)} does not cut {tiles} tiles "
                         f"into non-empty ranges")
    keys = torch.empty((n_split, m), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_merge_contacts(
            pos.data_ptr(), radius.data_ptr(), mass.data_ptr(),
            live.data_ptr(), m, float(factor), n_split, per, keys.data_ptr(),
            winner.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
