"""Force only with P targets per thread (K5g): the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of ``make_ptile(p, sub_t, chunk)`` in
``scripts/ablations/tune_r2g.py``, whose Pallas kernel runs P target
sub-tiles against one hoisted source broadcast; the kernel is
``csrc/ptile_forces.cu``, where each thread holds P targets and each
shared-memory source read serves P pairs, on ``csrc/pair_step.cuh``'s
chunked sweep: runs of 256 sources from each chunk's start, each summed
into fresh registers before it joins the total. The sources are staged
:func:`stage` at a time, a choice made from the chunk alone that leaves
the sums as they are; K5e's kernel (:mod:`.flavor_forces`) takes the same
stages through :func:`_launch`. When the target blocks cannot fill the
card the source sum is split into ranges of whole chunks
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
RUN = 256        # csrc/source_tiles.cuh kRun: sources a run
STAGE = 1024     # most sources a shared-memory stage

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


def stage(chunk: int) -> int:
    """Sources a shared-memory stage of the K5g and K5e kernels for chunks
    of ``chunk`` sources: the whole chunk up to STAGE; else the largest
    multiple of RUN up to STAGE that divides it; else STAGE, each chunk's
    last stage shorter. A chunk's stages start at its start, so a run of
    RUN sources and a batch of 8 lie in one stage and the sums are those of
    one stage a chunk. Two buffers of 12 bytes a source: at most 24 KB a
    block."""
    if chunk <= STAGE:
        return chunk
    return next((s for s in range(STAGE, 0, -RUN) if chunk % s == 0), STAGE)


def _launch(call, t: int, s: int, p: int, block: int, chunk: int,
            n_split: int | None, device: torch.device, what: str,
            sources: int | None = None):
    """``call(stage, n_split, part, out, stream)``, a C entry of K5g or K5e
    with its other arguments bound, over ``n_split`` source ranges (None:
    :func:`split_plan`) at :func:`stage`'s stage (or ``sources`` a stage,
    ``tune_r2g stages``' probe), on ``device``: the (2, T) result; raises
    if the launch failed. Counts nothing: each caller counts its own
    launches."""
    if n_split is None:
        n_split = split_plan(t, s, p, block, chunk, sm_count(
            device.index if device.index is not None
            else torch.cuda.current_device()))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"n_split must be in [1, 65535], got {n_split}")
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    part = (torch.empty((n_split, 2, t), dtype=torch.float32, device=device)
            if n_split > 1 else out)
    with torch.cuda.device(device):
        err = call(sources or stage(chunk), n_split, part.data_ptr(),
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, what)
    return out


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
    ``block`` threads per block, runs of 256 from the start of each chunk
    of ``chunk`` sources (staged :func:`stage` at a time). ``n_split``
    source ranges of whole chunks (None: :func:`split_plan`); either way
    one launch is counted. The kernel's registers let a block launch up to
    1024 threads at P <= 2, 896 at P = 4 and 512 at P = 8
    (``csrc/ptile_forces.cu``); a larger one raises at launch."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), device)
    _check("src", src, (3, s), device)
    _check_launch(block, chunk)
    if p not in PS:
        raise ValueError(f"p must be one of {PS}, got {p}")
    if device.type == "cpu":
        return ptile_acc_plain(tgt, src)
    out = _launch(lambda *rest: _lib().nbody_ptile_forces(
        tgt.data_ptr(), src.data_ptr(), t, s, p, block, chunk, *rest),
        t, s, p, block, chunk, n_split, device, "ptile_forces")
    global LAUNCHES
    LAUNCHES += 1
    return out[0:1], out[1:2]
