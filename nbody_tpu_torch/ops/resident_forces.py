"""Force only over chunks of sources in shared memory (K5a): the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``v2_acc`` in ``scripts/ablations/tune_r2.py`` (the Pallas
kernel ``_v2_kernel``); the kernel is ``csrc/resident_forces.cu``. The
script's ``tile_t`` (targets per grid step) is the block size here and its
``chunk`` the sources staged per pass. CPU tensors take the plain version;
CUDA tensors launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import torch

from .. import forces
from .direct_forces import _check, _device_of, _raise_on

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("resident_forces")


def _check_launch(block: int, chunk: int) -> None:
    if not (32 <= block <= 1024 and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    if not 1 <= chunk <= 12288:
        raise ValueError(f"chunk must be in [1, 12288], got {chunk}")


def v2_acc_plain(tgt_pos, tgt_radius, src, *, precise: bool = False):
    """Plain version of :func:`v2_acc`: the direct sum over the (3, S)
    source rows."""
    return forces.direct_sum_acc(tgt_pos, tgt_radius, src[:2].T, src[2],
                                 precise=precise)


def v2_acc(
    tgt_pos: torch.Tensor,     # (T, 2)
    tgt_radius: torch.Tensor,  # (T,)
    src: torch.Tensor,         # (3, S) rows x; y; gm
    *,
    block: int = 256,
    chunk: int = 2048,
    precise: bool = False,
) -> torch.Tensor:
    """(T, 2) fp32 accelerations of every target from the S sources, one
    thread per target, ``chunk`` sources staged through shared memory per
    pass (the ``v2_acc`` counterpart)."""
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src.shape[-1]
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src", src, (3, s), device)
    _check_launch(block, chunk)
    if device.type == "cpu":
        return v2_acc_plain(tgt_pos, tgt_radius, src, precise=precise)
    global LAUNCHES
    acc = torch.empty((t, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_resident_forces(
            tgt_pos.data_ptr(), tgt_radius.data_ptr(), src.data_ptr(), t, s,
            block, min(chunk, max(s, 1)), int(precise), acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "resident_forces")
    LAUNCHES += 1
    return acc
