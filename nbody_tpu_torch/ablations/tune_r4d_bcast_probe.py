"""K5i on the card: four ways to hand each source to every thread of a
warp, in the same REPS-fold direct sum.

Counterpart of ``scripts/ablations/tune_r4d_bcast_probe.py``, which swept
S = 4096 sources past T = 512 targets REPS = 2048 times in one Pallas
kernel and compared four Mosaic layouts of the source broadcast. Here the
kernel is ``csrc/bcast_probe.cu`` (:mod:`..ops.bcast_probe`): a
shared-memory broadcast (K1's way), ``__shfl_sync`` from the lane that
holds the source, ``__ldg`` of one address by the whole warp, and the
constant bank. The 2048 sweeps are split over blocks to fill the card and
their partials added in a fixed order. Inputs as the script draws them:
``np.random.RandomState(0)``, (3, T) targets then (3, S) sources, all
``randn``; the targets' third row is added to r2, so where it is negative
r2 can be too and the sum is NaN (246 of the 512 targets, on the TPU as
here). A second set takes that row's absolute value, so every target is
checked.

    python -m nbody_tpu_torch.ablations.tune_r4d_bcast_probe
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bcast_probe import VARIANTS, bcast_acc, bcast_acc_plain, split_plan
from ..ops.direct_forces import sm_count
from . import _scene

T, S = 512, 4096
REPS = 2048
# Against the plain version, max|d|/max|ref| over the finite entries: the
# plain version adds the same sweeps in the same order, so only one
# sweep's direct sum differs (order within a run, FMA contraction, MUFU):
# the direct force's bound (measured 3.2e-7 on an H100).
BOUND = 5e-6


def inputs(device, abs_row2: bool = False):
    """(tgt (3, T), src (3, S)) fp32, the script's draws."""
    rng = np.random.RandomState(0)
    tgt = rng.randn(3, T).astype(np.float32)
    src = rng.randn(3, S).astype(np.float32)
    if abs_row2:
        tgt[2] = np.abs(tgt[2])
    return torch.from_numpy(tgt).to(device), torch.from_numpy(src).to(device)


def run(device, log=print) -> list:
    """Each variant on both input sets: twice for bit-equality, against the
    plain version (once per set), timed."""
    pairs = T * S * REPS
    n_split = split_plan(T, REPS, sm_count(device.index or 0))
    log(f"  T={T} S={S} REPS={REPS}: {pairs:.4e} pairs, sweeps split over "
        f"{n_split} ranges")
    results = []
    for label, abs_row2 in (("script", False), ("|row 2|", True)):
        tgt, src = inputs(device, abs_row2)
        want = bcast_acc_plain(tgt, src, reps=REPS, n_split=n_split)
        nan_targets = int((~torch.isfinite(want)).any(dim=0).sum())
        for variant in VARIANTS:
            def call(variant=variant):
                return bcast_acc(tgt, src, variant=variant, reps=REPS,
                                 n_split=n_split)

            first, again = call(), call()
            torch.cuda.synchronize()
            same = _scene.bit_equal(first, again)
            err, same_nonfinite = _scene.rel_finite(first, want)
            ms = _scene.time_it(call)
            ok = same and same_nonfinite and err < BOUND
            log(f"  {label:>8} {variant:>5}: {ms:.4f} ms  "
                f"{pairs / (ms * 1e-3):.4e} pairs/s  max|d|/max|ref| "
                f"{err:.3e} over the finite entries, NaN where the plain "
                f"version has them {same_nonfinite} ({nan_targets} targets), "
                f"bit-equal {same}{'' if ok else '  FAIL'}")
            diff = (first - want)[torch.isfinite(want)].abs()
            results.append({"name": f"{variant} ({label})", "variant": variant,
                            "inputs": label, "ms": ms, "err": err, "ok": ok,
                            "n_split": n_split, "nan_targets": nan_targets,
                            "max_abs_err": float(diff.max())})
    return _scene.finish("K5i", results)


def main() -> None:
    device = _scene.require_cuda()
    print("K5i source-broadcast probe")
    run(device)


if __name__ == "__main__":
    main()
