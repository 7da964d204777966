"""K5e on the card: the reductions of the row-layout kernel, each against
its plain version.

Counterpart of ``scripts/ablations/tune_r2e.py``, whose ``make_v3`` ran
K5b's row kernel with four reductions: ``control`` (a per-chunk sum),
``partial_jnp`` (a (tile, 128) lane-partial carry), ``fma_kloop`` (128-wide
FMAs into that carry) and ``f_assoc`` (f = (gm·inv)·(inv·inv)). Here each
is a variant of ``csrc/flavor_forces.cu`` (:mod:`..ops.flavor_forces`), on
K5g's chunked sweep: the lanes become K chains a target (8 at P <= 2, 4 at
P = 4, 2 at P = 8), and the script's tile_t of 1024-4096 targets is P = 2-8
targets per thread in blocks of 512, its chunk the range of a chunk's sum
(staged ``ops/ptile_forces.stage`` at a time). Each line also gives the
stage and the pair loop's SASS a pair, registers and spills
(:func:`pair_loops`).

    python -m nbody_tpu_torch.ablations.tune_r2e [N]
    python -m nbody_tpu_torch.ablations.tune_r2e parent DIR

``parent`` times the sweep against another commit of the port, as
``tune_r2g parent`` does K5g's (``_side.py``'s "k5e" job: each side at
its own split plan, both reported): in turns on the N=65536 scene, bits,
each side's SASS a pair, registers and spills of every variant at every
P, and ``tune_r2c.sass_against``. JSON goes to ``build/tune_r2e/``.
Without a CUDA device each form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..ops import _build, sass
from ..ops.flavor_forces import (FLAVORS, as_acc, flavor_acc, flavor_acc_plain,
                                 plain_key, shape)
from ..ops.ptile_forces import PS, stage
from . import _scene
from .tune_r2g import (compare, in_turns, log_reading, log_row, loop_reading,
                       old_library)

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2e"

# (flavor, tile_t, chunk): tune_r2e.py:148-156
SWEEP = (
    ("fma_kloop", 1024, 2048),
    ("fma_kloop", 2048, 2048),
    ("fma_kloop", 2048, 1024),
    ("fma_kloop", 4096, 1024),
    ("fma_kloop", 1024, 4096),
    ("control", 1024, 2048),
    ("f_assoc", 1024, 2048),
)
# variant V of K5e's kernel at P targets a thread: this tree's
# flavor_kernel<P, V> or an older build's flavor_kernel<P, RowTargets, V>
KERNEL = r"flavor_kernelILi{p}E(?:N\w*?RowTargetsE)?Li{v}EE"


def pair_loops(lib: Path, log=print, label: str = "") -> dict:
    """{(flavor, P): :func:`.tune_r2g.loop_reading`} of each K5e kernel in
    the library (the ``.log`` of its build beside it)."""
    funcs = sass.functions(lib)
    usage = sass.ptxas_usage(lib.with_suffix(".log").read_text())
    out = {}
    for flavor, (variant, _, _) in FLAVORS.items():
        for p in PS:
            out[flavor, p] = loop_reading(funcs, usage,
                                          KERNEL.format(p=p, v=variant))
            log_reading(log, f"{label}flavor_forces {flavor} P={p}",
                        out[flavor, p])
    return out


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    plains, results = {}, []
    for flavor, tile_t, chunk in SWEEP:
        p, block = shape(tile_t)
        key = plain_key(flavor, p, chunk)
        if key not in plains:
            plains[key] = as_acc(flavor_acc_plain(tgt, src, flavor=flavor,
                                                  p=p, chunk=chunk))
        r = _scene.measure(
            f"{flavor}({tile_t}x{chunk}) p{p}",
            lambda flavor=flavor, p=p, block=block, chunk=chunk: flavor_acc(
                tgt, src, flavor=flavor, p=p, block=block, chunk=chunk),
            as_acc, plains[key], scene, k1_ms, log)
        r["config"] = {"flavor": flavor, "tile_t": tile_t, "p": p,
                       "block": block, "chunk": chunk, "stage": stage(chunk)}
        results.append(r)
    loops = pair_loops(_build.library_path("flavor_forces"), log)
    for r in results:
        r["sass"] = loops[r["config"]["flavor"], r["config"]["p"]]
    return _scene.finish("K5e", results)


def jobs(n: int = _scene.N, reps: int | None = 20) -> list:
    """One "k5e" job of ``_side.py`` a configuration of the sweep."""
    return [{"what": "k5e", "n": n, "flavor": flavor, "tile_t": tile_t,
             "chunk": chunk, "reps": reps} for flavor, tile_t, chunk in SWEEP]


def parent(other: Path, log=print) -> dict:
    from .tune_direct import _card
    from .tune_r2c import sass_against

    log(f"parent on {_card()}: this tree against {other}")
    work = jobs()
    times, outputs = in_turns(other, work, OUT / "parent")
    rows = []
    for i, job in enumerate(work):
        p, block = shape(job["tile_t"])
        row = {"flavor": job["flavor"], "tile_t": job["tile_t"], "p": p,
               "block": block, "chunk": job["chunk"],
               "stage": stage(job["chunk"]), **compare(times, outputs, i)}
        log_row(log, f"K5e {job['flavor']}({job['tile_t']}x{job['chunk']}) "
                f"p{p} stage {row['stage']}", row)
        rows.append(row)
    loops = {who: pair_loops(lib, log, f"{who} ") for who, lib in (
        ("old", old_library(other, "flavor_forces")),
        ("new", _build.library_path("flavor_forces")))}
    same = sass_against(other, ("ptile_forces", "flavor_forces"), log)
    return {"configs": rows,
            **{f"sass_{who}": {f"{f} P={p}": r for (f, p), r in got.items()}
               for who, got in loops.items()},
            "sass_same": same}


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
    run(scene, _scene.header("K5e v3 reductions", scene))


if __name__ == "__main__":
    main()
