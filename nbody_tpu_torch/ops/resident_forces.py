"""Force only over chunks of resident sources (K5a): the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``v2_acc`` in ``scripts/ablations/tune_r2.py`` (the Pallas
kernel ``_v2_kernel``). ``_v2_kernel`` is ``make_v2``'s ``kernel_cols``
(``tune_r2b.py``) with a ``precise`` switch, so K5a runs K5b's kernel,
``csrc/v2_forces.cu``, in the column layout, rsqrt or precise
(``gm / (sqrt(r2) * r2)``, IEEE sqrt and divide). Its sums are not K5b's
one chain a chunk, whose error grows with the chunk (5.5e-6 of the
force's max against the direct sum at chunk 4096, over the 5e-6 bound):
runs of 256 sources are summed into fresh registers and each added to the
total in order, as K5a's kernel summed before it ran there. The script's
``tile_t`` (targets per grid step) is ``block`` here, run as P targets a
thread in blocks of ``block / P`` threads (``v2_forces.shape``: P = 2 from
256 on), and its ``chunk`` the sources staged per pass, a multiple of 8 up
to ``v2_forces.MAX_CHUNK`` (two stages of 12 bytes a source in a block's
shared memory). When the target blocks cannot fill the card the source
sum is split into ranges of whole chunks (K5g's ``split_plan``; or
``n_split``), added in range order.

The plain version is the direct sum (``forces.direct_sum_acc``). CPU
tensors take it; CUDA tensors launch the kernel, and anything wrong there
raises.
"""

from __future__ import annotations

import torch

from .. import forces
from ..types import round_up
from .direct_forces import _check, _device_of

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _check_launch(block: int, chunk: int) -> None:
    """The block and chunk ranges of K5g's kernel (``csrc/ptile_forces.cu``)."""
    if not (32 <= block <= 1024 and block % 32 == 0):
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    if not 1 <= chunk <= 12288:
        raise ValueError(f"chunk must be in [1, 12288], got {chunk}")


def shape(block: int, chunk: int) -> tuple[int, int]:
    """(P, threads) of ``block`` targets a block, after checking that
    ``csrc/v2_forces.cu`` takes them and ``chunk``."""
    from . import v2_forces as v2  # it imports ptile_forces, which imports this

    p, threads = v2.shape(block)
    if not (32 <= threads <= v2.MAX_BLOCK and threads % 32 == 0
            and p * threads == block):
        raise ValueError(
            f"block (targets a block) must be a multiple of 32 in [32, 256) "
            f"or of 64 in [256, {2 * v2.MAX_BLOCK}], got {block}")
    if not (8 <= chunk <= v2.MAX_CHUNK and chunk % 8 == 0):
        raise ValueError(f"chunk must be a multiple of 8 in [8, {v2.MAX_CHUNK}] "
                         f"(two stages of 12 bytes a source in {v2.SMEM} "
                         f"bytes of shared memory), got {chunk}")
    return p, threads


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
    block: int = 512,
    chunk: int = 2048,
    precise: bool = False,
    n_split: int | None = None,
) -> torch.Tensor:
    """(T, 2) fp32 accelerations of every target from the S sources,
    ``block`` targets a block, ``chunk`` sources staged through shared
    memory per pass (the ``v2_acc`` counterpart), over ``n_split`` source
    ranges (None: the split plan) in one counted launch."""
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src.shape[-1]
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src", src, (3, s), device)
    p, threads = shape(block, chunk)
    if device.type == "cpu":
        return v2_acc_plain(tgt_pos, tgt_radius, src, precise=precise)
    from . import v2_forces as v2

    # the script's chunk = min(chunk, S): one chunk where S is shorter
    acc = v2._launch((tgt_pos.data_ptr(), tgt_radius.data_ptr()), src, t,
                     False, v2.K5A[precise], p, threads,
                     min(chunk, round_up(max(s, 1), 8)), n_split,
                     "resident_forces (K5a on v2_forces)")
    global LAUNCHES
    LAUNCHES += 1
    return acc
