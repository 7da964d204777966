"""K5i on the card: four ways to hand each source to every thread of a
warp, in the same REPS-fold direct sum.

Counterpart of ``scripts/ablations/tune_r4d_bcast_probe.py``, which swept
S = 4096 sources past T = 512 targets REPS = 2048 times in one Pallas
kernel and compared four Mosaic layouts of the source broadcast. Here the
kernel is ``csrc/bcast_probe.cu`` (:mod:`..ops.bcast_probe`), two targets
a thread: a shared-memory broadcast, ``__shfl_sync`` from the lane that
holds the source, ``__ldg`` of one address by the whole warp, and the
constant bank. The 2048 sweeps are split over blocks to fill the card and
their partials added in a fixed order. Inputs as the script draws them:
``np.random.RandomState(0)``, (3, T) targets then (3, S) sources, all
``randn``; the targets' third row is added to r2, so where it is negative
r2 can be too and the sum is NaN (246 of the 512 targets, on the TPU as
here). A second set takes that row's absolute value, so every target is
checked. The four variants add the same terms in the same order, so each
is also held bit for bit to the first.

    python -m nbody_tpu_torch.ablations.tune_r4d_bcast_probe
    python -m nbody_tpu_torch.ablations.tune_r4d_bcast_probe parent DIR

``parent`` times the probe against another commit of the port, whose
package DIR holds (``git archive <commit> nbody_tpu_torch | tar -x -C
DIR``): each side in a process of its own through its public wrapper
(``_side.py``'s "k5i" job), in turns (old, new, new, old), each at its own
split plan; the bits of each variant on both input sets against the other
side's at the other side's split; the pairs with 0 < r2 < FLT_MIN (where
the ftz rsqrt and ``rsqrtf`` would differ); and each side's pair loop per
variant (SASS a pair). JSON goes to ``build/tune_r4d_bcast_probe/``.
Without a CUDA device either form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build, sass
from ..ops.bcast_probe import (VARIANTS, bcast_acc, bcast_acc_plain,
                               split_plan, subnormal_pairs)
from ..ops.direct_forces import sm_count
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r4d_bcast_probe"

T, S = 512, 4096
REPS = 2048
INPUTS = (("script", False), ("|row 2|", True))
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
    plain version (once per set) and against the first variant, timed."""
    pairs = T * S * REPS
    n_split = split_plan(T, REPS, sm_count(device.index or 0))
    log(f"  T={T} S={S} REPS={REPS}: {pairs:.4e} pairs, sweeps split over "
        f"{n_split} ranges")
    results = []
    for label, abs_row2 in INPUTS:
        tgt, src = inputs(device, abs_row2)
        want = bcast_acc_plain(tgt, src, reps=REPS, n_split=n_split)
        nan_targets = int((~torch.isfinite(want)).any(dim=0).sum())
        sub, least = subnormal_pairs(tgt, src)
        log(f"  {label:>8}: {sub} pairs with 0 < r2 < FLT_MIN, the smallest "
            f"positive r2 {least:.4e}")
        first_variant = None
        for variant in VARIANTS:
            def call(variant=variant):
                return bcast_acc(tgt, src, variant=variant, reps=REPS,
                                 n_split=n_split)

            first, again = call(), call()
            torch.cuda.synchronize()
            same = _scene.bit_equal(first, again)
            if first_variant is None:
                first_variant = first
            as_first = _scene.bit_equal(first, first_variant)
            err, same_nonfinite = _scene.rel_finite(first, want)
            ms = _scene.time_it(call)
            ok = same and same_nonfinite and err < BOUND
            log(f"  {label:>8} {variant:>5}: {ms:.4f} ms  "
                f"{pairs / (ms * 1e-3):.4e} pairs/s  max|d|/max|ref| "
                f"{err:.3e} over the finite entries, NaN where the plain "
                f"version has them {same_nonfinite} ({nan_targets} targets), "
                f"bit-equal {same}, to {VARIANTS[0]} {as_first}"
                f"{'' if ok else '  FAIL'}")
            diff = (first - want)[torch.isfinite(want)].abs()
            results.append({"name": f"{variant} ({label})", "variant": variant,
                            "inputs": label, "ms": ms, "err": err, "ok": ok,
                            "n_split": n_split, "nan_targets": nan_targets,
                            "subnormal_pairs": sub, "equal_to_first": as_first,
                            "max_abs_err": float(diff.max())})
    return _scene.finish("K5i", results)


def pair_loops(lib, log=print, label: str = "bcast_probe") -> dict:
    """{variant: SASS a pair} of a build of ``csrc/bcast_probe.cu``: each
    kernel's largest innermost loop over its MUFU.RSQ, one a pair."""
    funcs = sass.functions(lib)
    out = {}
    for v, variant in enumerate(VARIANTS):
        name = sass.find(funcs, rf"bcast_kernelILi{v}E")
        n, mufu = sass.pair_loop(funcs[name], "MUFU")
        if not mufu:
            raise RuntimeError(f"no pair loop found in {name}")
        out[variant] = n / mufu
        log(f"  {label} {variant:>5}: pair loop {n} SASS instructions for "
            f"{mufu} pairs, {n / mufu:.2f} a pair")
    return out


def jobs(n_split: int | None = None, reps: int | None = 20) -> list:
    """One "k5i" job of ``_side.py`` a variant and input set."""
    return [{"what": "k5i", "variant": v, "abs_row2": a, "n_split": n_split,
             "reps": reps} for _, a in INPUTS for v in VARIANTS]


def parent(other: Path, log=print) -> dict:
    from .tune_direct import _card, _side_run

    log(f"parent on {_card()}: this tree against {other}")
    timed = jobs()
    times = {"old": [], "new": []}
    bits = []
    for turn, who in enumerate(("old", "new", "new", "old")):
        if turn == 1:  # this tree at the other's split, for the bits
            bits = jobs(times["old"][0][0]["n_split"], reps=None)
        res = _side_run(other if who == "old" else ROOT,
                        (bits if turn == 1 else []) + timed,
                        OUT / "parent" / f"{turn}")
        times[who].append(res[len(bits) if turn == 1 else 0:])
    rows = []
    for i, job in enumerate(timed):
        o, n = ([t[i]["ms"] for t in times[who]] for who in ("old", "new"))
        (old,), (new,) = (torch.load(OUT / "parent" / t / f"{i}.pt")
                          for t in ("0", "1"))
        fin = torch.isfinite(old)
        row = {"variant": job["variant"], "abs_row2": job["abs_row2"],
               "old": o, "new": n, "ratio": sum(n) / sum(o),
               "old_split": times["old"][0][i]["n_split"],
               "new_split": times["new"][0][i]["n_split"],
               "equal": _scene.bit_equal(old, new),
               "nan_equal": torch.equal(fin, torch.isfinite(new))}
        log(f"  {job['variant']:>5} {'|row 2|' if job['abs_row2'] else 'script':>8}:"
            f" old (split {row['old_split']}) {o[0]:.4f}, {o[1]:.4f}; new "
            f"(split {row['new_split']}) {n[0]:.4f}, {n[1]:.4f} ms; new/old "
            f"{row['ratio']:.4f}; at the old split bits "
            f"{'equal' if row['equal'] else 'DIFFERENT'}, NaN positions "
            f"{'equal' if row['nan_equal'] else 'DIFFERENT'}")
        rows.append(row)
    subnormal = {}
    for label, abs_row2 in INPUTS:
        subnormal[label] = subnormal_pairs(*inputs("cpu", abs_row2))
        log(f"  {label}: {subnormal[label][0]} pairs with 0 < r2 < FLT_MIN, "
            f"the smallest positive r2 {subnormal[label][1]:.4e}")
    theirs = sorted((other / "build" / "kernels").glob("libbcast_probe-*.so"))
    if len(theirs) != 1:
        raise RuntimeError(f"expected one bcast_probe build in {other}, got {theirs}")
    mine = _build.build_all(["bcast_probe"])["bcast_probe"][0]
    return {"configs": rows, "subnormal_pairs": subnormal,
            "old_sass_a_pair": pair_loops(theirs[0], log, "old bcast_probe"),
            "new_sass_a_pair": pair_loops(mine, log, "new bcast_probe")}


def main(argv: list[str] | None = None) -> None:
    device = _scene.require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "parent":
        if len(argv) != 2:
            raise SystemExit(__doc__)
        out = parent(Path(argv[1]).resolve())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "parent.json").write_text(json.dumps(out, indent=1))
        return
    print("K5i source-broadcast probe")
    run(device)


if __name__ == "__main__":
    main()
