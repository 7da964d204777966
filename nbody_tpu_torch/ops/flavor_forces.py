"""Build-time flavors of the chunked force (K5b, K5e, K5c): the CUDA kernel's
wrapper and a plain PyTorch version of each flavor.

Counterparts of ``make_v2`` in ``scripts/ablations/tune_r2b.py`` (its
``kernel_cols`` and ``kernel_rows``), ``make_v3`` in ``tune_r2e.py`` and
``make_probe`` in ``tune_r2c.py``. The kernel is ``csrc/flavor_forces.cu``:
``source_tiles.cuh``'s chunked force (K5a and K5g's) with a pair policy, a
sum policy and an unroll chosen at build time, P targets per thread and
``block`` threads per block, so that the script's ``tile_t`` is ``p *
block``. Each script flavor maps to one variant:

======================  ===========================================  =====
script flavor           Hopper variant                               P
======================  ===========================================  =====
K5b base, rows; K5e     per-chunk run (the script's per-chunk        any
control; K5c full       ``jnp.sum``), one chain
K5b ``unroll=2``        ``unroll2``: two 8-source batches per pass   any
K5b static              ``static``: four batches per pass (a         any
                        runtime chunk count cannot be unrolled)
K5b partial, K5e        ``partial``: K chains per chunk folded into  any
partial_jnp             K lane sums, summed in lane order at the end
K5e fma_kloop           K chains fed straight by the FFMAs, folded   any
                        into the total every 256 sources
K5e f_assoc             f = (gm·inv)·(inv·inv), per-chunk run        any
K5c unroll16            16 batches per pass                          1
K5c skeleton, no_rsqrt,  the script's pair math with one piece gone   1
no_cube, no_gm,         (skeleton and one_axis leave ay at 0;
one_axis, no_reduce     no_reduce adds the first source of each
                        staged chunk only)
======================  ===========================================  =====

K (:func:`chains`) is 8 at P <= 2, 4 at P = 4 and 2 at P = 8: the TPU's 128
lane partials, as many as a thread's registers hold at 512 threads. The
column layout (``tgt`` a pair (pos (T, 2), radius (T,)), result (T, 2)) is
the script's ``kernel_cols`` and takes variants 0-3 (K5b's); the row layout
(``tgt`` (3, T) rows x; y; r, result ((1, T), (1, T))) takes every flavor.
When the target blocks cannot fill the card, the source sum is split into
ranges of whole chunks as K5g's (:func:`~.ptile_forces.split_plan`).

Each plain version follows the kernel's association: the per-chunk sums
added in chunk order, the chains and the lane sums folded in order, the
probes' dropped terms. It does not follow a source split (a different
grouping of whole-chunk sums). CPU tensors take the plain version; CUDA
tensors launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import torch

from ..types import SOFTENING_FLOOR
from .direct_forces import _check, _device_of, _raise_on, sm_count
from .ptile_forces import PS, split_plan

# name: (variant of csrc/flavor_forces.cu, pair math, sum)
FLAVORS = {
    "base": (0, "direct", "chunk"),
    "rows": (0, "direct", "chunk"),
    "control": (0, "direct", "chunk"),
    "full": (0, "direct", "chunk"),
    "unroll2": (1, "direct", "chunk"),
    "static": (2, "direct", "chunk"),
    "partial": (3, "direct", "lanes"),
    "partial_jnp": (3, "direct", "lanes"),
    "fma_kloop": (4, "direct", "chains"),
    "f_assoc": (5, "assoc", "chunk"),
    "unroll16": (6, "direct", "chunk"),
    "skeleton": (7, "skeleton", "chunk"),
    "no_rsqrt": (8, "no_rsqrt", "chunk"),
    "no_cube": (9, "no_cube", "chunk"),
    "no_gm": (10, "no_gm", "chunk"),
    "one_axis": (11, "one_axis", "chunk"),
    "no_reduce": (12, "direct", "first"),
}
COL_VARIANTS = 4           # variants 0-3 (K5b's) also take the column layout
WIDE_VARIANTS = 6          # variants 0-5 run at every P, the others at P = 1
RUN = 256                  # csrc/source_tiles.cuh kRun: fma_kloop's close
MAX_BLOCK = 512

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("flavor_forces")


def chains(p: int) -> int:
    """Independent chains per target for the partial and fma_kloop
    variants at p targets per thread."""
    return 8 if p <= 2 else 16 // p


def shape(tile_t: int) -> tuple[int, int]:
    """(P, block) of a script's tile_t: P * block = tile_t, block at most
    MAX_BLOCK."""
    p = max(1, tile_t // MAX_BLOCK)
    return p, tile_t // p


def plain_key(flavor: str, p: int, chunk: int) -> tuple:
    """What a flavor's plain version depends on: its math, its sum, the
    chunk and (for chains and lanes) the chain count."""
    _, pair, how = FLAVORS[flavor]
    return pair, how, chunk, chains(p) if how in ("lanes", "chains") else 0


def as_acc(out) -> torch.Tensor:
    """(T, 2) from either layout's result."""
    if isinstance(out, torch.Tensor):
        return out
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def _check_flavor(flavor: str, p: int, block: int, chunk: int, rows: bool):
    if flavor not in FLAVORS:
        raise ValueError(f"flavor must be one of {sorted(FLAVORS)}, got {flavor!r}")
    if p not in PS:
        raise ValueError(f"p must be one of {PS}, got {p}")
    if not (32 <= block <= MAX_BLOCK and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 in [32, {MAX_BLOCK}], got {block}")
    if not (8 <= chunk <= 12288 and chunk % 8 == 0):
        raise ValueError(f"chunk must be a multiple of 8 in [8, 12288], got {chunk}")
    if FLAVORS[flavor][0] >= WIDE_VARIANTS and p != 1:
        raise ValueError(f"flavor {flavor!r} runs at p = 1 only, got {p}")
    if not rows and FLAVORS[flavor][0] >= COL_VARIANTS:
        raise ValueError(f"flavor {flavor!r} takes (3, T) target rows only")


def _terms(pair: str, tx, ty, soft, sx, sy, gm):
    """(ex, ey) of every (target, source) pair: (t, 1) targets against
    (1, s) sources, ey None where the flavor leaves ay at 0."""
    dx = sx - tx
    if pair == "skeleton":
        return dx, None
    dy = sy - ty
    r2 = dx * dx + dy * dy + soft
    if pair == "no_rsqrt":
        f = r2
    else:
        inv = torch.rsqrt(r2)
        if pair == "no_cube":
            f = inv
        elif pair == "no_gm":
            f = inv * inv * inv
        elif pair == "assoc":
            f = (gm * inv) * (inv * inv)
        else:
            f = gm * (inv * inv * inv)
    return dx * f, (None if pair == "one_axis" else dy * f)


def _fold(parts):
    """parts[0] + parts[1] + ..., in that order."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def _chain_sums(e, k: int):
    """(t, k) sums of e's columns by column index mod k."""
    t, s = e.shape
    pad = -s % k
    if pad:
        e = torch.cat([e, e.new_zeros((t, pad))], dim=1)
    return e.reshape(t, -1, k).sum(dim=1)


def _reduce(e, how: str, chunk: int, k: int):
    """The kernel's sum of e (t, s) over its sources, for one target row
    block: per-chunk runs added in chunk order ("chunk"), K chains per
    chunk carried as lanes ("lanes"), K chains folded every RUN sources
    ("chains"), or the first source of each chunk ("first")."""
    t, s = e.shape
    starts = range(0, s, chunk)
    if how == "first":
        return _fold([e[:, lo] for lo in starts])
    if how == "chunk":
        return _fold([e[:, lo:lo + chunk].sum(dim=1) for lo in starts])
    if how == "lanes":
        lanes = _fold([_chain_sums(e[:, lo:lo + chunk], k) for lo in starts])
        return _fold(list(lanes.unbind(dim=1)))
    runs = []
    for lo in starts:
        c = e[:, lo:lo + chunk]
        full = c.shape[1] // RUN * RUN
        if full:
            per_run = c[:, :full].reshape(t, -1, RUN // k, k).sum(dim=2)
            runs += list(_fold(list(per_run.unbind(dim=2))).unbind(dim=1))
        if full < c.shape[1]:
            runs.append(_fold(list(_chain_sums(c[:, full:], k).unbind(dim=1))))
    return _fold(runs)


def flavor_acc_plain(tgt, src, *, flavor: str = "base", p: int = 1,
                     chunk: int = 2048):
    """Plain version of :func:`flavor_acc`, in the same layout, over blocks
    of targets (2**25 pair terms a block on the card, 2**22 on the CPU)."""
    rows = isinstance(tgt, torch.Tensor)
    _, pair, how = FLAVORS[flavor]
    if rows:
        tx, ty, tr = tgt[0], tgt[1], tgt[2]
    else:
        pos, radius = tgt
        tx, ty, tr = pos[:, 0], pos[:, 1], radius
    t, s = tx.shape[0], src.shape[-1]
    soft = tr + SOFTENING_FLOOR
    k = chains(p)
    elems = 1 << (25 if src.device.type == "cuda" else 22)
    step = max(1, elems // max(s, 1))
    ax, ay = torch.zeros_like(tx), torch.zeros_like(tx)
    for i in range(0, t if s else 0, step):
        sl = slice(i, i + step)
        ex, ey = _terms(pair, tx[sl, None], ty[sl, None], soft[sl, None],
                        src[0][None], src[1][None], src[2][None])
        ax[sl] = _reduce(ex, how, chunk, k)
        if ey is not None:
            ay[sl] = _reduce(ey, how, chunk, k)
    if rows:
        return ax[None], ay[None]
    return torch.stack([ax, ay], dim=-1)


def flavor_acc(
    tgt,                # (3, T) rows x; y; r, or (pos (T, 2), radius (T,))
    src: torch.Tensor,  # (3, S) rows x; y; gm
    *,
    flavor: str = "base",
    p: int = 1,
    block: int = 512,
    chunk: int = 2048,
):
    """The force by one flavor (module docstring): ((1, T), (1, T)) for
    (3, T) rows, (T, 2) for a (pos, radius) pair, over K5g's source split
    plan in one counted launch."""
    rows = isinstance(tgt, torch.Tensor)
    src_dev = _device_of(src)
    if rows:
        t = tgt.shape[-1]
        _check("tgt", tgt, (3, t), src_dev)
        ptrs = (tgt.data_ptr(), None)
    else:
        pos, radius = tgt
        t = pos.shape[0]
        _check("tgt_pos", pos, (t, 2), src_dev)
        _check("tgt_radius", radius, (t,), src_dev)
        ptrs = (pos.data_ptr(), radius.data_ptr())
    s = src.shape[-1]
    _check("src", src, (3, s), src_dev)
    _check_flavor(flavor, p, block, chunk, rows)
    if src_dev.type == "cpu":
        return flavor_acc_plain(tgt, src, flavor=flavor, p=p, chunk=chunk)
    n_split = split_plan(t, s, p, block, chunk, sm_count(
        src_dev.index if src_dev.index is not None
        else torch.cuda.current_device()))
    global LAUNCHES
    out = torch.empty((2, t) if rows else (t, 2), dtype=torch.float32,
                      device=src_dev)
    part = (torch.empty((n_split, *out.shape), dtype=torch.float32,
                        device=src_dev) if n_split > 1 else out)
    with torch.cuda.device(src_dev):
        err = _lib().nbody_flavor_forces(
            *ptrs, src.data_ptr(), t, s, int(rows), FLAVORS[flavor][0], p,
            block, chunk, n_split, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"flavor_forces ({flavor})")
    LAUNCHES += 1
    return (out[0:1], out[1:2]) if rows else out
