"""K5c on the card: the row-layout kernel with one piece of the pair math
taken out at a time, timed, and read in SASS.

Counterpart of ``scripts/ablations/tune_r2c.py``, whose ``make_probe`` ran
K5b's row kernel at TILE_T 512 and CHUNK 2048 with ``full`` math, the
chunk loop unrolled 16 times, or one piece dropped (``skeleton``: the loop
and ax += dx; ``no_rsqrt``: f = r2; ``no_cube``: f = inv; ``no_gm``: f =
inv³; ``one_axis``: no ay; ``no_reduce``: only the first source of each
chunk counts). The results are wrong physics except ``full`` and
``unroll16``; the point is the time. Here each is a variant of
``csrc/flavor_forces.cu`` at one target per thread in blocks of 512 (the
script's tile), and its line also gives the pair loop's length in SASS
(``cuobjdump -sass`` of the built library, the largest innermost loop,
over its shared-memory reads: one a source, however far nvcc unrolled
the loop), the Hopper reading of the script's "slots/pair".
``no_reduce`` has no pair loop left: nvcc drops the pairs whose terms are
never added, and its largest loop is the staging loop.

    python -m nbody_tpu_torch.ablations.tune_r2c [N]
"""

from __future__ import annotations

import sys

from ..ops import _build, sass
from ..ops.flavor_forces import FLAVORS, as_acc, flavor_acc, flavor_acc_plain
from . import _scene

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
# Every flavor is held to the direct force's 5e-6 against its plain
# version. Those without gm (skeleton, no_rsqrt, no_cube, no_gm) sum terms
# that do not fall off as the force does and cancel (no_rsqrt's dx·r2
# reaches 1e17), yet on the N=65536 scene the per-chunk fp32 runs stayed
# within 3.0e-6 of the plain version's sums (H100: skeleton 5.9e-7,
# no_rsqrt 7.2e-7, no_cube 8.0e-7, no_gm 3.0e-6).


def pairs(flavor: str, n: int, s: int, chunk: int = CHUNK) -> int:
    """The pairs a flavor computes: every one, or the first source of each
    chunk for no_reduce."""
    return n * (-(-s // chunk) if flavor == "no_reduce" else s)


def loop_length(flavor: str, funcs: dict | None = None) -> tuple[int, int]:
    """(instructions, shared-memory reads) in the largest innermost loop of
    the flavor's kernel (P = 1, row targets) in the built library."""
    if funcs is None:
        funcs = sass.functions(_build.library_path("flavor_forces"))
    name = sass.find(funcs, rf"flavor_kernelILi1E.*RowTargetsELi"
                            rf"{FLAVORS[flavor][0]}EE")
    return sass.pair_loop(funcs[name])


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    funcs = sass.functions(_build.library_path("flavor_forces"))
    results = []
    for flavor in FLAVORS_C:
        want = as_acc(flavor_acc_plain(tgt, src, flavor=flavor, chunk=CHUNK))
        r = _scene.measure(
            flavor, lambda flavor=flavor: flavor_acc(
                tgt, src, flavor=flavor, p=1, block=TILE_T, chunk=CHUNK),
            as_acc, want, scene, k1_ms, log)
        n_loop, per_pass = loop_length(flavor, funcs)
        if flavor == "no_reduce":
            per_pass = 0      # the largest loop left stages sources
        r["config"] = {"flavor": flavor, "tile_t": TILE_T, "chunk": CHUNK,
                       "sass_loop": n_loop, "sources_per_pass": per_pass,
                       "pairs": pairs(flavor, scene.n, scene.s128)}
        if per_pass:
            r["sass_per_pair"] = n_loop / per_pass
            log(f"  {'':>24}  SASS pair loop {n_loop} instructions for "
                f"{per_pass} sources: {n_loop / per_pass:.2f} a pair")
        else:
            log(f"  {'':>24}  no pair loop (largest loop {n_loop} "
                f"instructions: the staging loop)")
        results.append(r)
    return _scene.finish("K5c", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5c op-cost probes", scene))


if __name__ == "__main__":
    main()
