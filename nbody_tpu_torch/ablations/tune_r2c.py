"""K5c on the card: the row-layout kernel with one piece of the pair math
taken out at a time, timed, and read in SASS.

Counterpart of ``scripts/ablations/tune_r2c.py``, whose ``make_probe`` ran
K5b's row kernel at TILE_T 512 and CHUNK 2048 with ``full`` math, the
chunk loop unrolled 16 times, or one piece dropped (``skeleton``: the loop
and ax += dx; ``no_rsqrt``: f = r2; ``no_cube``: f = inv; ``no_gm``: f =
inv³; ``one_axis``: no ay; ``no_reduce``: only the first source of each
chunk counts). The results are wrong physics except ``full`` and
``unroll16``; the point is the time. Here each is a row-layout variant of
K5b's kernel, ``csrc/v2_forces.cu`` (:mod:`..ops.v2_forces`), at the
script's tile of 512 = P 2 × 256 threads, its sources staged through
double-buffered ``cp.async`` copies, and its line also gives the pair
loop's length in SASS (``cuobjdump -sass`` of the built library, the
largest innermost loop), the Hopper reading of the script's "slots/pair":
the loop's instructions over its pairs, counted as K5b's
(``tune_r2b.pair_loops``) by MUFU.RSQ, one a pair, where the probe keeps
an rsqrt; else by the shared-memory loads, a batch of 8 sources being 6
16-byte loads (4 where the probe never reads gm, 2 for skeleton's x
alone) serving P targets.
``no_reduce`` has no pair loop left: nvcc drops the pairs whose terms are
never added, and its largest loop is the staging loop.

    python -m nbody_tpu_torch.ablations.tune_r2c [N]
    python -m nbody_tpu_torch.ablations.tune_r2c parent DIR

``parent`` times the eight probes against another commit of the port,
whose package DIR holds (``git archive <commit> nbody_tpu_torch | tar -x
-C DIR``): each side in a process of its own through its public wrapper
(``_side.py``'s "k5c" job: ``v2_forces.v2_acc`` where the tree has K5c's
flavors, else ``flavor_forces.flavor_acc`` at P = 1 in blocks of 512), in
turns (old, new, new, old) on the N=65536 scene; each probe's bits, this
tree at P = 2 and at P = 1, against the other side's; each side's SASS a
pair; and whether every other kernel of the other commit compiled to the
same SASS here (``sass_against``; K5d's ``stationary_forces.cu`` left
out). JSON goes to
``build/tune_r2c/``. Without a CUDA device either form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops import v2_forces as v2
from ..ops.flavor_forces import as_acc
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2c"

TILE_T = 512
CHUNK = 2048
FLAVORS_C = ("full", "unroll16", "skeleton", "no_rsqrt", "no_cube", "no_gm",
             "one_axis", "no_reduce")
# (fp32 operations, MUFU operations) a pair: the direct sum's 13 (dx, dy;
# r2, 4; inv^3, 2; gm, 1; dx*f, dy*f and their adds, 4) less what the
# flavor drops.
OPS = {"full": (13, 1), "unroll16": (13, 1), "skeleton": (2, 0),
       "no_rsqrt": (10, 0), "no_cube": (10, 1), "no_gm": (12, 1),
       "one_axis": (11, 1), "no_reduce": (13, 1)}
# The probes whose pair reads no gm: their terms do not vanish on the
# gm = 0 rows that pad the sources to S128.
NO_GM = ("skeleton", "no_rsqrt", "no_cube", "no_gm")
# 16-byte shared-memory loads of a staged batch of 8 sources that a probe's
# pair loop issues: 6 (x, y and gm), 4 without gm, 2 for skeleton (x alone;
# read off its SASS: 2 LDS.128 a pass of 8 sources)
LOADS_A_BATCH = {"skeleton": 2, "no_rsqrt": 4, "no_cube": 4, "no_gm": 4}
# the probes' kernels in csrc/v2_forces.cu (mangled-name patterns)
KERNELS = {"full": r"v2_kernelILi{p}E.*RowTargetsELi1ELb0E",
           "unroll16": r"v2_kernelILi{p}E.*RowTargetsELi16ELb0E",
           "skeleton": r"v2_probe_kernelILi{p}E.*SkeletonMath",
           "no_rsqrt": r"v2_probe_kernelILi{p}E.*NoRsqrtMath",
           "no_cube": r"v2_probe_kernelILi{p}E.*NoCubeMath",
           "no_gm": r"v2_probe_kernelILi{p}E.*NoGmMath",
           "one_axis": r"v2_probe_kernelILi{p}E.*OneAxisMath",
           "no_reduce": r"v2_probe_kernelILi{p}E.*FirstOnlyMath"}
# Every flavor is held to the direct force's 5e-6 against its plain
# version. Those without gm (skeleton, no_rsqrt, no_cube, no_gm) sum terms
# that do not fall off as the force does and cancel (no_rsqrt's dx·r2
# reaches 1e17), yet on the N=65536 scene the per-chunk fp32 runs stayed
# within 3.0e-6 of the plain version's sums (H100: skeleton 5.9e-7,
# no_rsqrt 7.2e-7, no_cube 8.0e-7, no_gm 3.0e-6).


def pairs(flavor: str, n: int, mass_len: int, s: int,
          chunk: int = CHUNK) -> int:
    """The pairs a flavor's function needs: N × mass_len where a pair's
    term carries gm (the gm = 0 rows that pad the sources add nothing),
    N × S where it does not (those rows count), and N × chunks for
    no_reduce (the first source of each chunk)."""
    if flavor == "no_reduce":
        return n * -(-s // chunk)
    return n * (s if flavor in NO_GM else mass_len)


def loop_length(flavor: str, p: int = 2, funcs: dict | None = None
                ) -> tuple[int, float, str]:
    """(instructions, pairs, how they were counted) in the largest
    innermost loop of the flavor's row kernel at P targets a thread in the
    built ``v2_forces`` library: the MUFU.RSQ count where the probe keeps an
    rsqrt, else its shared-memory loads × 8 sources a batch over the
    batch's loads × P."""
    if funcs is None:
        funcs = sass.functions(_build.library_path("v2_forces"))
    code = funcs[sass.find(funcs, KERNELS[flavor].format(p=p))]
    n, mufu = sass.pair_loop(code, "MUFU")
    if OPS[flavor][1]:
        return n, mufu, "MUFU.RSQ"
    n, lds = sass.pair_loop(code, "LDS")
    per_batch = LOADS_A_BATCH.get(flavor, 6)
    return n, lds * 8 / per_batch * p, f"LDS x 8/{per_batch} x P"


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Each probe at P = 2 (the script's tile) against its plain version,
    twice bit-equal, timed, with its pair loop's SASS a pair at P = 1 and
    2."""
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    funcs = sass.functions(_build.library_path("v2_forces"))
    p, block = v2.shape(TILE_T)
    results = []
    for flavor in FLAVORS_C:
        want = as_acc(v2.v2_acc_plain(tgt, src, flavor=flavor, chunk=CHUNK))
        r = _scene.measure(
            flavor, lambda flavor=flavor: v2.v2_acc(
                tgt, src, flavor=flavor, p=p, block=block, chunk=CHUNK),
            as_acc, want, scene, k1_ms, log)
        r["config"] = {"flavor": flavor, "tile_t": TILE_T, "p": p,
                       "block": block, "chunk": CHUNK,
                       "pairs": pairs(flavor, scene.n, scene.mass_len,
                                      scene.s128)}
        sass_text = []
        for q in (1, 2):
            n_loop, n_pairs, how = loop_length(flavor, q, funcs)
            r["config"][f"sass_loop_p{q}"] = n_loop
            if flavor != "no_reduce" and n_pairs:
                r[f"sass_per_pair_p{q}"] = n_loop / n_pairs
                sass_text.append(f"P={q} {n_loop} instructions for "
                                 f"{n_pairs:g} pairs ({how}): "
                                 f"{n_loop / n_pairs:.2f} a pair")
            else:
                sass_text.append(f"P={q} no pair loop (largest loop {n_loop} "
                                 f"instructions: the staging loop)")
        r["sass_per_pair"] = r.get("sass_per_pair_p2")
        log(f"  {'':>24}  SASS " + "; ".join(sass_text))
        results.append(r)
    return _scene.finish("K5c", results)


def jobs(n: int = _scene.N, reps: int | None = 20) -> list:
    """One "k5c" job of ``_side.py`` a probe and P."""
    return [{"what": "k5c", "n": n, "flavor": flavor, "p": p, "reps": reps}
            for p in (2, 1) for flavor in FLAVORS_C]


def old_pair_loops(lib: Path, log=print) -> dict:
    """{flavor: SASS a pair} of K5c's kernels in an older build of
    ``csrc/flavor_forces.cu`` (variants 0 and 6-12 at P = 1 on row targets;
    the old reading: the loop's instructions over its LDS, one a source)."""
    funcs = sass.functions(lib)
    out = {}
    variants = dict(zip(FLAVORS_C, (0, 6, 7, 8, 9, 10, 11, 12)))
    for flavor, variant in variants.items():
        name = sass.find(funcs, rf"flavor_kernelILi1E.*RowTargetsELi{variant}EE")
        n, mufu = sass.pair_loop(funcs[name], "MUFU")
        _, lds = sass.pair_loop(funcs[name], "LDS")
        count, how = (mufu, "MUFU.RSQ") if OPS[flavor][1] else (lds, "LDS")
        if flavor == "no_reduce" or not count:
            log(f"  old flavor_forces {flavor:>9} P=1: no pair loop "
                f"(largest loop {n} instructions)")
            continue
        out[flavor] = n / count
        log(f"  old flavor_forces {flavor:>9} P=1: pair loop {n} SASS "
            f"instructions for {count} pairs ({how}), {n / count:.2f} a pair")
    return out


def sass_against(other: Path, skip: tuple, log=print) -> dict:
    """{library: {kernel: same SASS}}: every kernel of each library that
    the other commit built under ``other/build`` (all but ``skip``, whose
    kernels were redesigned) against this tree's build of it, a kernel
    that this tree lacks counting as different. (``flavor_forces`` was
    once compared the other way round, when K5c's kernels left it and
    K5e's stayed; K5e's now run on ``pair_step.cuh``'s chunked sweep, so
    against a commit from before that ``flavor_forces`` goes in
    ``skip``.)"""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    mine = {name: path for name, (path, _) in _build.build_all(names).items()}
    same = {}
    for name in names:
        if name in skip:
            continue
        theirs = sorted((other / "build" / "kernels").glob(f"lib{name}-*.so"))
        if len(theirs) != 1:
            raise RuntimeError(f"expected one {name} build in {other}, got {theirs}")
        same[name] = sass.diff(theirs[0], mine[name])
        log(f"  {name}: {sum(same[name].values())} of {len(same[name])} "
            f"kernels compiled to the same SASS in both commits"
            + ("" if all(same[name].values()) else
               f"; DIFFERENT: {[k for k, v in same[name].items() if not v]}"))
    return same


def parent(other: Path, log=print) -> dict:
    from .tune_direct import _card, _side_run

    log(f"parent on {_card()}: this tree against {other}")
    old_jobs = [j for j in jobs() if j["p"] == 2]   # the old side ignores p
    new_jobs = jobs()
    build = {"what": "build",
             "names": sorted(p.stem for p in _build.CSRC.glob("*.cu"))}
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        head = [build] if turn == 0 else []
        res = _side_run(other if who == "old" else ROOT,
                        head + (old_jobs if who == "old" else new_jobs),
                        OUT / "parent" / f"{turn}")
        times[who].append(res[len(head):])
    rows = []
    for i, job in enumerate(old_jobs):
        flavor = job["flavor"]
        (old,) = torch.load(OUT / "parent" / "0" / f"{i + 1}.pt")
        row = {"flavor": flavor, "old": [t[i]["ms"] for t in times["old"]]}
        for k, nj in enumerate(new_jobs):
            if nj["flavor"] != flavor:
                continue
            (new,) = torch.load(OUT / "parent" / "1" / f"{k}.pt")
            row[f"new_p{nj['p']}"] = [t[k]["ms"] for t in times["new"]]
            row[f"equal_p{nj['p']}"] = _scene.bit_equal(old, new)
            row[f"rel_p{nj['p']}"] = _scene.rel(new, old)
        row["ratio"] = sum(row["new_p2"]) / sum(row["old"])
        log(f"  {flavor:>9}: old P=1 " + ", ".join(f"{t:.4f}" for t in row["old"])
            + "; new P=2 " + ", ".join(f"{t:.4f}" for t in row["new_p2"])
            + f" ms; new/old {row['ratio']:.4f}; bits P=2 "
            f"{'equal' if row['equal_p2'] else 'DIFFERENT'} (max|d|/max|old| "
            f"{row['rel_p2']:.3e}), P=1 "
            f"{'equal' if row['equal_p1'] else 'DIFFERENT'} "
            f"({row['rel_p1']:.3e}); new P=1 "
            + ", ".join(f"{t:.4f}" for t in row["new_p1"]) + " ms")
        rows.append(row)
    theirs = sorted((other / "build" / "kernels").glob("libflavor_forces-*.so"))
    old_sass = old_pair_loops(theirs[0], log) if len(theirs) == 1 else {}
    funcs = sass.functions(_build.build_all(["v2_forces"])["v2_forces"][0])
    new_sass = {}
    for flavor in FLAVORS_C:
        for p in (1, 2):
            n, count, how = loop_length(flavor, p, funcs)
            if flavor != "no_reduce" and count:
                new_sass[f"{flavor} P={p}"] = n / count
                log(f"  v2_forces {flavor:>9} P={p}: pair loop {n} SASS "
                    f"instructions for {count:g} pairs ({how}), "
                    f"{n / count:.2f} a pair")
    same = sass_against(other, ("stationary_forces",), log)
    return {"configs": rows, "old_sass_a_pair": old_sass,
            "new_sass_a_pair": new_sass, "sass_same": same}


def main(argv: list[str] | None = None) -> None:
    _scene.require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "parent":
        if len(argv) != 2:
            raise SystemExit(__doc__)
        out = parent(Path(argv[1]).resolve())
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "parent.json").write_text(json.dumps(out, indent=1))
        return
    n = int(argv[0]) if argv else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5c op-cost probes", scene))


if __name__ == "__main__":
    main()
