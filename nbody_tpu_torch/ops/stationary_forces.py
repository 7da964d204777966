"""Force only, source-stationary (K5d): the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``make_k3(tile_t, chunk, manual_reduce)`` in
``scripts/ablations/tune_r2d.py``, whose Pallas kernel walks source chunks
in a sequential grid and revisits one (2, T) accumulator; the kernel is
``csrc/stationary_forces.cu``, where each block keeps one chunk in shared
memory, walks target tiles, and writes per-chunk partials that a second
pass sums in chunk order. Its pair step is K5a's and K5b's
(``csrc/pair_step.cuh``): two targets a thread from tiles of 64 targets
on (:func:`shape`), an unguarded ``rsqrt.approx.ftz``, and each target's
sources summed in runs of 256 within a chunk. The plain version follows
the same schedule: a (2, T) partial per chunk, its runs of 256 summed in
order, the partials summed in chunk order. ``manual_reduce`` only chose
how the TPU's lanes reduce; it has no counterpart. CPU tensors take the
plain version; CUDA tensors launch the kernel, and anything wrong there
raises.
"""

from __future__ import annotations

import torch

from .. import forces
from .direct_forces import _check, _device_of, _raise_on, sm_count

MAX_THREADS = 512   # csrc/stationary_forces.cu kMaxThreads
MAX_CHUNK = 12288
RUN = 256           # csrc/source_tiles.cuh kRun: sources a run of add_runs
BLOCKS_PER_SM = 64  # the slab plan's target

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("stationary_forces")


def shape(block: int) -> tuple[int, int]:
    """(P, threads) of a tile of ``block`` targets: two targets a thread from
    64 on, one below; the threads a multiple of 32 up to MAX_THREADS."""
    p = 2 if block >= 64 else 1
    threads = block // p
    if not (32 <= threads <= MAX_THREADS and threads % 32 == 0
            and p * threads == block):
        raise ValueError(f"block (targets a tile) must be 32 or a multiple of "
                         f"64 in [64, {2 * MAX_THREADS}], got {block}")
    return p, threads


def slab_plan(t: int, s: int, block: int, chunk: int, sms: int) -> int:
    """Slabs of whole target tiles of ``block`` targets per source chunk:
    enough for about BLOCKS_PER_SM blocks an SM, at most one a tile, at
    least one (each block walks every tile). Many short blocks, run in
    waves, keep every SM busy to the end; the precise path, whose IEEE
    divide is latency-bound, needs them most (``ablations.tune_r2d
    slabs``; PERF.md §6)."""
    chunks, tiles = s // chunk, -(-t // block)
    if chunks == 0:
        return 1
    return max(1, min(tiles, -(-BLOCKS_PER_SM * sms // chunks)))


def stationary_acc_plain(tgt, src, *, chunk: int, precise: bool = False):
    """Plain version of :func:`stationary_acc`: within each chunk, runs of
    RUN sources each summed and added in order; the chunks' (2, T) partials
    summed in chunk order."""
    t, s = tgt.shape[-1], src.shape[-1]
    out = torch.zeros((2, t), dtype=torch.float32, device=tgt.device)
    for lo in range(0, s, chunk):
        part = torch.zeros_like(out)
        for a in range(lo, min(lo + chunk, s), RUN):
            b = min(a + RUN, lo + chunk, s)
            part += forces.direct_sum_acc(tgt[:2].T, tgt[2], src[:2, a:b].T,
                                          src[2, a:b], precise=precise).T
        out += part
    return out


def stationary_acc(
    tgt: torch.Tensor,   # (3, T) rows x; y; r
    src: torch.Tensor,   # (3, S) rows x; y; gm, S a multiple of chunk
    *,
    block: int = 256,
    chunk: int = 512,
    slabs: int | None = None,
    precise: bool = False,
) -> torch.Tensor:
    """(2, T) fp32 accelerations: one block per (source chunk, slab of
    target tiles of ``block`` targets, :func:`shape`'s P a thread);
    ``slabs`` None is :func:`slab_plan`. S must be a whole number of chunks
    (pad with gm = 0 rows, as the script does). Two launches on the card,
    counted as one."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), device)
    _check("src", src, (3, s), device)
    p, threads = shape(block)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of chunk = {chunk}")
    if device.type == "cpu":
        return stationary_acc_plain(tgt, src, chunk=chunk, precise=precise)
    if slabs is None:
        slabs = slab_plan(t, s, block, chunk, sm_count(
            device.index if device.index is not None
            else torch.cuda.current_device()))
    if not 1 <= slabs <= 65535:
        raise ValueError(f"slabs must be in [1, 65535], got {slabs}")
    global LAUNCHES
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    part = torch.empty((max(s // chunk, 1), 2, t), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_stationary_forces(
            tgt.data_ptr(), src.data_ptr(), t, s, p, threads, chunk, slabs,
            int(precise), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "stationary_forces")
    LAUNCHES += 1
    return out
