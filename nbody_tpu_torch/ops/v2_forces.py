"""K5b: the resident-source force of ``make_v2`` in its two target layouts
and its sweep's flavors, the CUDA kernel's wrapper and its plain PyTorch
version. The kernel also runs K5a (``resident_forces.v2_acc``: variants
``K5A[precise]``, the column layout summed in runs of 256 sources).

Counterpart of ``make_v2`` in ``scripts/ablations/tune_r2b.py`` (its
``kernel_cols`` and ``kernel_rows``). The kernel is ``csrc/v2_forces.cu``,
K5b's own, designed for Hopper: an unguarded ``rsqrt.approx.ftz``, P
targets per thread in blocks of ``block`` threads (the script's ``tile_t``
is ``p * block``; :func:`shape` takes P = 2 from tile 256 on), and the
sources staged ``chunk`` at a time as three rows through double-buffered
``cp.async`` copies. Each script flavor maps to one variant:

=================  ==============================================  =======
script flavor      Hopper variant                                  unroll
=================  ==============================================  =======
base, rows         each chunk's terms in one chain, added to the   1
                   total in chunk order
``unroll=2``       ``unroll2``: the same sums                      2
static             ``static``: the same sums (a runtime chunk      4
                   count cannot be unrolled; the pair loop is)
partial            ``partial``: CHAINS chains a chunk (source k    1
                   on chain k % CHAINS) added to CHAINS lane
                   sums, folded in lane order at the end
=================  ==============================================  =======

The unroll counts 8-source batches a pass of the pair loop. The column
layout (``tgt`` a pair (pos (T, 2), radius (T,)), result (T, 2)) is the
script's ``kernel_cols``, the row layout (``tgt`` (3, T) rows x; y; r,
result ((1, T), (1, T))) its ``kernel_rows``; every flavor takes both.
When the target blocks cannot fill the card, the source sum is split into
ranges of whole chunks (:func:`~.ptile_forces.split_plan`) added in range
order.

The plain version follows the kernel's association: per-chunk sums added
in chunk order, or the chains and lane sums folded in order. It does not
follow a source split (a different grouping of whole-chunk sums). CPU
tensors take the plain version; CUDA tensors launch the kernel, and
anything wrong there raises.
"""

from __future__ import annotations

import torch

from .direct_forces import _check, _device_of, _raise_on, sm_count
from .flavor_forces import chunked_sum_plain
from .ptile_forces import split_plan

# name: variant of csrc/v2_forces.cu
FLAVORS = {"base": 0, "rows": 0, "unroll2": 1, "static": 2, "partial": 3}
K5A = {False: 4, True: 5}  # K5a's variants (rsqrt, precise), columns only
PS = (1, 2)
CHAINS = 8                 # csrc/v2_forces.cu kChains: partial's lane sums
MAX_BLOCK = 512
SMEM = 232448              # the dynamic shared memory a block can have
# two stages of three fp32 rows a chunk
MAX_CHUNK = SMEM // (2 * 3 * 4) // 8 * 8

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("v2_forces")


def shape(tile_t: int) -> tuple[int, int]:
    """(P, block) of a script's tile_t: two targets a thread from 256 on."""
    p = 2 if tile_t >= 256 else 1
    return p, tile_t // p


def plain_key(flavor: str, chunk: int) -> tuple:
    """What a flavor's plain version depends on: its sum and the chunk."""
    return flavor == "partial", chunk


def _check_v2(flavor: str, p: int, block: int, chunk: int):
    if flavor not in FLAVORS:
        raise ValueError(f"flavor must be one of {sorted(FLAVORS)}, got {flavor!r}")
    if p not in PS:
        raise ValueError(f"p must be one of {PS}, got {p}")
    if not (32 <= block <= MAX_BLOCK and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 in [32, {MAX_BLOCK}], got {block}")
    if not (8 <= chunk <= MAX_CHUNK and chunk % 8 == 0):
        raise ValueError(f"chunk must be a multiple of 8 in [8, {MAX_CHUNK}] (two "
                         f"stages of 12 bytes a source in {SMEM} bytes of shared "
                         f"memory), got {chunk}")


def v2_acc_plain(tgt, src, *, flavor: str = "base", chunk: int = 2048):
    """Plain version of :func:`v2_acc`, in the same layout."""
    rows = isinstance(tgt, torch.Tensor)
    t3 = tgt if rows else torch.stack([tgt[0][:, 0], tgt[0][:, 1], tgt[1]])
    ax, ay = chunked_sum_plain(t3, src, how="lanes" if flavor == "partial"
                               else "chunk", chunk=chunk, k=CHAINS)
    return (ax, ay) if rows else torch.stack([ax[0], ay[0]], dim=-1)


def v2_acc(
    tgt,                # (3, T) rows x; y; r, or (pos (T, 2), radius (T,))
    src: torch.Tensor,  # (3, S) rows x; y; gm
    *,
    flavor: str = "base",
    p: int = 2,
    block: int = 256,
    chunk: int = 2048,
    n_split: int | None = None,
):
    """The force by one flavor (module docstring): ((1, T), (1, T)) for
    (3, T) rows, (T, 2) for a (pos, radius) pair, over ``n_split`` source
    ranges of whole chunks (None: K5g's split plan) in one counted
    launch."""
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
    _check_v2(flavor, p, block, chunk)
    if src_dev.type == "cpu":
        return v2_acc_plain(tgt, src, flavor=flavor, chunk=chunk)
    out = _launch(ptrs, src, t, rows, FLAVORS[flavor], p, block, chunk,
                  n_split, f"v2_forces ({flavor})")
    global LAUNCHES
    LAUNCHES += 1
    return (out[0:1], out[1:2]) if rows else out


def _launch(ptrs: tuple, src: torch.Tensor, t: int, rows: bool, variant: int,
            p: int, block: int, chunk: int, n_split: int | None,
            what: str) -> torch.Tensor:
    """One call of ``nbody_v2_forces`` on the card of ``src``: the
    (2, T) or (T, 2) result over ``n_split`` source ranges (None: K5g's
    split plan); raises if the launch failed. Counts nothing: each caller
    counts its own launches."""
    dev, s = src.device, src.shape[-1]
    if n_split is None:
        n_split = split_plan(t, s, p, block, chunk, sm_count(
            dev.index if dev.index is not None
            else torch.cuda.current_device()))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"n_split must be in [1, 65535], got {n_split}")
    out = torch.empty((2, t) if rows else (t, 2), dtype=torch.float32,
                      device=dev)
    part = (torch.empty((n_split, *out.shape), dtype=torch.float32,
                        device=dev) if n_split > 1 else out)
    with torch.cuda.device(dev):
        err = _lib().nbody_v2_forces(
            *ptrs, src.data_ptr(), t, s, int(rows), variant, p, block, chunk,
            n_split, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, what)
    return out
