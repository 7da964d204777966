"""Force only with P targets per thread (K5g): the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``make_ptile(p, sub_t, chunk)`` in
``scripts/ablations/tune_r2g.py``, whose Pallas kernel runs P target
sub-tiles against one hoisted source broadcast; the kernel is
``csrc/ptile_forces.cu``, where each thread holds P targets and each
shared-memory source read serves P pairs. When the target blocks cannot
fill the card the source sum is split into ranges of whole chunks
(:func:`~.direct_forces.split_ranges`) summed in a fixed order. CPU
tensors take the plain version; CUDA tensors launch the kernel, and
anything wrong there raises.
"""

from __future__ import annotations

import torch

from .. import forces
from .direct_forces import _check, _device_of, _raise_on, sm_count, split_ranges
from .resident_forces import _check_launch

PS = (1, 2, 4, 8)

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("ptile_forces")


def split_plan(t: int, s: int, p: int, block: int, chunk: int, sms: int) -> int:
    """Source ranges for T targets in blocks of p * block and S sources in
    chunks of ``chunk``, on a card of ``sms`` SMs."""
    return split_ranges(-(-t // (p * block)), -(-s // chunk), sms)


def ptile_acc_plain(tgt, src):
    """Plain version of :func:`ptile_acc`: the direct sum, rsqrt path."""
    acc = forces.direct_sum_acc(tgt[:2].T, tgt[2], src[:2].T, src[2],
                                precise=False)
    return acc[:, 0][None], acc[:, 1][None]


def ptile_acc(
    tgt: torch.Tensor,   # (3, T) rows x; y; r
    src: torch.Tensor,   # (3, S) rows x; y; gm
    *,
    p: int = 4,
    block: int = 256,
    chunk: int = 2048,
    n_split: int | None = None,
):
    """(ax, ay), each (1, T) fp32, rsqrt path: ``p`` targets per thread,
    ``block`` threads per block, ``chunk`` sources per shared-memory pass.
    ``n_split`` source ranges (None: :func:`split_plan`); either way one
    launch is counted."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), device)
    _check("src", src, (3, s), device)
    _check_launch(block, chunk)
    if p not in PS:
        raise ValueError(f"p must be one of {PS}, got {p}")
    if device.type == "cpu":
        return ptile_acc_plain(tgt, src)
    if n_split is None:
        n_split = split_plan(t, s, p, block, chunk, sm_count(
            device.index if device.index is not None
            else torch.cuda.current_device()))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"n_split must be in [1, 65535], got {n_split}")
    global LAUNCHES
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    part = (torch.empty((n_split, 2, t), dtype=torch.float32, device=device)
            if n_split > 1 else out)
    with torch.cuda.device(device):
        err = _lib().nbody_ptile_forces(
            tgt.data_ptr(), src.data_ptr(), t, s, p, block, chunk, n_split,
            part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ptile_forces")
    LAUNCHES += 1
    return out[0:1], out[1:2]
