"""Force only, source-stationary (K5d): the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``make_k3(tile_t, chunk, manual_reduce)`` in
``scripts/ablations/tune_r2d.py``, whose Pallas kernel walks source chunks
in a sequential grid and revisits one (2, T) accumulator; the kernel is
``csrc/stationary_forces.cu``, where each block keeps one chunk in shared
memory, walks target tiles, and writes per-chunk partials that a second
pass sums in chunk order. The plain version follows the same schedule: a
(2, T) partial per chunk, summed in chunk order. ``manual_reduce`` only
chose how the TPU's lanes reduce; it has no counterpart. CPU tensors take
the plain version; CUDA tensors launch the kernel, and anything wrong
there raises.
"""

from __future__ import annotations

import torch

from .. import forces
from .direct_forces import _check, _device_of, _raise_on, sm_count
from .resident_forces import _check_launch

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("stationary_forces")


def slab_plan(t: int, s: int, block: int, chunk: int, sms: int) -> int:
    """Slabs of whole target tiles per source chunk: 1 (each block walks
    every tile) when the chunks alone give two blocks per SM; else enough
    for about two blocks per SM, at most one per tile."""
    chunks, tiles = s // chunk, -(-t // block)
    if chunks == 0 or chunks >= 2 * sms:
        return 1
    return max(1, min(tiles, -(-2 * sms // chunks)))


def stationary_acc_plain(tgt, src, *, chunk: int, precise: bool = False):
    """Plain version of :func:`stationary_acc`: each chunk's (2, T) force,
    summed in chunk order."""
    out = torch.zeros((2, tgt.shape[-1]), dtype=torch.float32,
                      device=tgt.device)
    for lo in range(0, src.shape[-1], chunk):
        part = forces.direct_sum_acc(tgt[:2].T, tgt[2], src[:2, lo:lo + chunk].T,
                                     src[2, lo:lo + chunk], precise=precise)
        out += part.T
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
    target tiles of ``block`` targets); ``slabs`` None is
    :func:`slab_plan`. S must be a whole number of chunks (pad with gm = 0
    rows, as the script does). Two launches on the card, counted as one."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), device)
    _check("src", src, (3, s), device)
    _check_launch(block, chunk)
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
            tgt.data_ptr(), src.data_ptr(), t, s, block, chunk, slabs,
            int(precise), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "stationary_forces")
    LAUNCHES += 1
    return out
