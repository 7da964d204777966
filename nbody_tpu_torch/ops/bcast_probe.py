"""Source-broadcast probe (K5i): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``run(tgt, src, variant=...)`` in
``scripts/ablations/tune_r4d_bcast_probe.py``, whose Pallas kernel sweeps
S sources past T targets REPS times and compares four Mosaic layouts of
the source broadcast. The kernel is ``csrc/bcast_probe.cu``; its four
variants (``VARIANTS``: shared memory, ``__shfl_sync``, ``__ldg`` of one
address, the constant bank) compute the same function, P = 2 targets a
thread (each source read serves both) with an unguarded
``rsqrt.approx.ftz``,

    ax_i, ay_i = reps * sum_j (dx, dy) * gm_j * inv**3,
    inv = rsqrt(dx*dx + dy*dy + r_i),

with each target's third row added to r2 as the script adds it (no
softening floor: where r2 < 0 the sum is NaN, on the TPU as here; where
0 < r2 < FLT_MIN the ftz rsqrt would differ from ``rsqrtf``, and
:func:`subnormal_pairs` counts such pairs). The shared-memory variant
stages the sources as ``csrc/pair_step.cuh``'s batches (x, y and gm rows of
8 side by side, 12 bytes a source) rather than a float4 a source. The sum
has a fixed order: a sweep sums runs of 256 sources, then the runs in
order; each of ``n_split`` blocks adds its share of the sweeps in order,
and the blocks' partials are added in block order. The plain version
follows that order except inside a run (one sweep computed once, then
added ``reps`` times). CPU tensors take the plain version; CUDA tensors
launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import torch

from .direct_forces import _check, _device_of, _raise_on, sm_count, split_ranges

VARIANTS = ("smem", "shfl", "ldg", "const")
THREADS = 256     # csrc/bcast_probe.cu kThreads: threads per block
P = 2             # csrc/bcast_probe.cu kP: targets per thread
RUN = 256         # sources per run of a sweep
MAX_SRC = 4096    # the constant bank holds 4096 sources

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _lib():
    from . import _build

    return _build.load("bcast_probe")


def split_plan(t: int, reps: int, sms: int) -> int:
    """Ranges of whole sweeps for T targets, in blocks of P * THREADS, on a
    card of ``sms`` SMs."""
    return split_ranges(-(-t // (P * THREADS)), reps, sms)


def subnormal_pairs(tgt: torch.Tensor, src: torch.Tensor) -> tuple[int, float]:
    """(pairs with 0 < r2 < FLT_MIN, the smallest positive r2) of one
    sweep, r2 = dx*dx + dy*dy + r as the kernel adds it (without its FMA):
    where the count is 0, the ftz rsqrt and ``rsqrtf`` agree on every
    pair."""
    dx = src[0][None] - tgt[0][:, None]
    dy = src[1][None] - tgt[1][:, None]
    r2 = dx * dx + dy * dy + tgt[2][:, None]
    tiny = torch.finfo(torch.float32).tiny
    pos = r2[r2 > 0]
    return (int(((r2 > 0) & (r2 < tiny)).sum()),
            float(pos.min()) if pos.numel() else float("nan"))


def sweep_plain(tgt: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(2, T): one sweep, runs of RUN sources added in order."""
    dx = src[0][None] - tgt[0][:, None]
    dy = src[1][None] - tgt[1][:, None]
    inv = torch.rsqrt(dx * dx + dy * dy + tgt[2][:, None])
    f = src[2][None] * (inv * inv * inv)
    t, s = dx.shape
    out = []
    for e in (dx * f, dy * f):
        runs = [e[:, a:a + RUN].sum(dim=1) for a in range(0, s, RUN)]
        total = torch.zeros(t, dtype=e.dtype, device=e.device)
        for r in runs:
            total = total + r
        out.append(total)
    return torch.stack(out)


def bcast_acc_plain(tgt: torch.Tensor, src: torch.Tensor, *, reps: int,
                    n_split: int = 1) -> torch.Tensor:
    """Plain version of :func:`bcast_acc`: one sweep added ``reps`` times,
    in the kernel's ranges of ``n_split`` and its order."""
    sweep = sweep_plain(tgt, src)
    per = -(-reps // n_split) if reps else 0
    parts = []
    for k in range(n_split):
        part = torch.zeros_like(sweep)
        for _ in range(max(0, min(per, reps - k * per))):
            part = part + sweep
        parts.append(part)
    if n_split == 1:
        return parts[0]
    total = torch.zeros_like(sweep)
    for part in parts:
        total = total + part
    return total


def bcast_acc(
    tgt: torch.Tensor,   # (3, T) rows x; y; r (r added to r2)
    src: torch.Tensor,   # (3, S) rows x; y; gm, S a multiple of 32 <= 4096
    *,
    variant: str = "smem",
    reps: int = 2048,
    n_split: int | None = None,
) -> torch.Tensor:
    """(2, T) rows ax; ay: ``reps`` times the direct sum, the sources
    reaching the warp by ``variant``. ``n_split`` ranges of sweeps (None:
    :func:`split_plan`); either way one launch is counted."""
    device = _device_of(tgt)
    t, s = tgt.shape[-1], src.shape[-1]
    _check("tgt", tgt, (3, t), device)
    _check("src", src, (3, s), device)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if not (32 <= s <= MAX_SRC and s % 32 == 0):
        raise ValueError(f"S must be a multiple of 32 in [32, {MAX_SRC}], got {s}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if device.type == "cpu":
        return bcast_acc_plain(tgt, src, reps=reps, n_split=n_split or 1)
    if n_split is None:
        n_split = split_plan(t, reps, sm_count(
            device.index if device.index is not None
            else torch.cuda.current_device()))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"n_split must be in [1, 65535], got {n_split}")
    global LAUNCHES
    out = torch.empty((2, t), dtype=torch.float32, device=device)
    part = (torch.empty((n_split, 2, t), dtype=torch.float32, device=device)
            if n_split > 1 else out)
    packed = torch.empty((s, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_bcast_probe(
            tgt.data_ptr(), src.data_ptr(), t, s, VARIANTS.index(variant),
            reps, n_split, packed.data_ptr(), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"bcast_probe ({variant})")
    LAUNCHES += 1
    return out
