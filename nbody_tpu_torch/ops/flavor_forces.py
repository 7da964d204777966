"""Build-time flavors of the chunked force (K5e): the CUDA kernel's wrapper
and a plain PyTorch version of each flavor, and the plain sums that K5b's
and K5c's (:mod:`.v2_forces`) share.

Counterpart of ``make_v3`` in ``scripts/ablations/tune_r2e.py``. The
kernel is ``csrc/flavor_forces.cu``: ``pair_step.cuh``'s chunked sweep
(K5g's) with a sum policy and a pair math chosen at build time, P targets
per thread and ``block`` threads per block, so that the script's
``tile_t`` is ``p * block``; its stages are K5g's
(:func:`~.ptile_forces.stage`, through :func:`~.ptile_forces._launch`).
Each script flavor maps to one variant:

======================  ===========================================  =====
script flavor           Hopper variant                               P
======================  ===========================================  =====
control                 per-chunk run (the script's per-chunk        any
                        ``jnp.sum``), one chain
partial_jnp             ``partial``: K chains per chunk folded into  any
                        K lane sums, summed in lane order at the end
fma_kloop               K chains fed straight by the FFMAs, folded   any
                        into the total every 256 sources
f_assoc                 f = (gm·inv)·(inv·inv), per-chunk run        any
======================  ===========================================  =====

K (:func:`chains`) is 8 at P <= 2, 4 at P = 4 and 2 at P = 8: the TPU's 128
lane partials, as many as a thread's registers hold at 512 threads. Targets
are (3, T) rows x; y; r, results ((1, T), (1, T)). K5b (``make_v2``, with
its column layout) and K5c (``tune_r2c.py``'s op-cost probes) run in a
kernel of their own, :mod:`.v2_forces`. When the target blocks cannot fill
the card, the source sum is split into ranges of whole chunks as K5g's
(:func:`~.ptile_forces.split_plan`).

Each plain version follows the kernel's association: the per-chunk sums
added in chunk order, the chains and the lane sums folded in order.
:func:`chunked_sum_plain` also gives K5c's probes' math (their dropped
terms, or the first source of each chunk). It does not follow a source
split (a different grouping of whole-chunk sums). CPU tensors take the
plain version; CUDA tensors launch the kernel, and anything wrong there
raises.
"""

from __future__ import annotations

import torch

from ..types import SOFTENING_FLOOR
from . import ptile_forces as ptf
from .direct_forces import _check, _device_of
from .ptile_forces import PS, RUN  # RUN: fma_kloop's close

# name: (variant of csrc/flavor_forces.cu, pair math, sum)
FLAVORS = {
    "control": (0, "direct", "chunk"),
    "partial_jnp": (3, "direct", "lanes"),
    "fma_kloop": (4, "direct", "chains"),
    "f_assoc": (5, "assoc", "chunk"),
}
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
    """(T, 2) from a (T, 2) result or a ((1, T), (1, T)) row pair."""
    if isinstance(out, torch.Tensor):
        return out
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def _check_flavor(flavor: str, p: int, block: int, chunk: int):
    if flavor not in FLAVORS:
        raise ValueError(f"flavor must be one of {sorted(FLAVORS)}, got {flavor!r}")
    if p not in PS:
        raise ValueError(f"p must be one of {PS}, got {p}")
    if not (32 <= block <= MAX_BLOCK and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 in [32, {MAX_BLOCK}], got {block}")
    if not (8 <= chunk <= 12288 and chunk % 8 == 0):
        raise ValueError(f"chunk must be a multiple of 8 in [8, 12288], got {chunk}")


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


def chunked_sum_plain(tgt, src, *, pair: str = "direct", how: str = "chunk",
                      chunk: int = 2048, k: int = 1):
    """The force on (3, T) target rows by pair math ``pair`` (:func:`_terms`)
    and sum ``how`` over chunks of ``chunk`` with ``k`` chains
    (:func:`_reduce`), ((1, T), (1, T)), over blocks of targets (2**25 pair
    terms a block on the card, 2**22 on the CPU)."""
    tx, ty, tr = tgt[0], tgt[1], tgt[2]
    t, s = tx.shape[0], src.shape[-1]
    soft = tr + SOFTENING_FLOOR
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
    return ax[None], ay[None]


def flavor_acc_plain(tgt, src, *, flavor: str = "control", p: int = 1,
                     chunk: int = 2048):
    """Plain version of :func:`flavor_acc`."""
    _, pair, how = FLAVORS[flavor]
    return chunked_sum_plain(tgt, src, pair=pair, how=how, chunk=chunk,
                             k=chains(p))


def flavor_acc(
    tgt: torch.Tensor,  # (3, T) rows x; y; r
    src: torch.Tensor,  # (3, S) rows x; y; gm
    *,
    flavor: str = "control",
    p: int = 1,
    block: int = 512,
    chunk: int = 2048,
):
    """(ax, ay), each (1, T), by one flavor (module docstring), over K5g's
    source split plan in one counted launch."""
    if not isinstance(tgt, torch.Tensor):
        raise ValueError("flavor_acc takes (3, T) target rows; K5b's column "
                         "layout is ops.v2_forces.v2_acc's")
    src_dev = _device_of(src)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), src_dev)
    _check("src", src, (3, s), src_dev)
    _check_flavor(flavor, p, block, chunk)
    if src_dev.type == "cpu":
        return flavor_acc_plain(tgt, src, flavor=flavor, p=p, chunk=chunk)
    out = ptf._launch(lambda *rest: _lib().nbody_flavor_forces(
        tgt.data_ptr(), src.data_ptr(), t, s, FLAVORS[flavor][0], p, block,
        chunk, *rest), t, s, p, block, chunk, None, src_dev,
        f"flavor_forces ({flavor})")
    global LAUNCHES
    LAUNCHES += 1
    return out[0:1], out[1:2]
