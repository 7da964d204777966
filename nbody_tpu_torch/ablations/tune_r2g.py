"""K5g on the card: force only with P targets per thread, each
shared-memory source read serving P pairs.

Counterpart of ``scripts/ablations/tune_r2g.py``. The script's
(P, sub_t, chunk) sweep becomes (P, block, chunk): P targets per thread,
``block`` threads per block, ``chunk`` sources a range of the sum (staged
``ops/ptile_forces.stage`` at a time). Each configuration takes the
source split of ``split_plan`` when its target blocks cannot fill the
card; one configuration is also run without it (split 1) to show what
that costs. Each line also gives the stage and the pair loop's SASS a
pair, registers and spills (:func:`pair_loops`).

    python -m nbody_tpu_torch.ablations.tune_r2g [N]
    python -m nbody_tpu_torch.ablations.tune_r2g parent DIR
    python -m nbody_tpu_torch.ablations.tune_r2g stages

``parent`` times the sweep against another commit of the port, whose
package DIR holds (``git archive <commit> nbody_tpu_torch | tar -x -C
DIR``): each side in a process of its own through its public wrapper
(``_side.py``'s "k5g" job, each configuration at its own ``n_split``
where it gives one, else at each tree's split plan, both reported), in
turns (old, new, new, old) on the N=65536 scene; each configuration's
force bit for bit against the other side's; each side's SASS a pair,
registers and spills at every P; and whether every other kernel of the
other commit compiled to the same SASS here (``tune_r2c.sass_against``).
``stages`` times K5g's and K5e's best configurations of the sweeps at
every stage the C entries take for their chunk (256 to 4096 sources, each
dividing it) on the N=65536 scene, each bit for bit against the stage
that ``ops/ptile_forces.stage`` picks. JSON goes to ``build/tune_r2g/``.
Without a CUDA device each form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops.direct_forces import sm_count
from ..ops.ptile_forces import PS, ptile_acc, ptile_acc_plain, split_plan, stage
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2g"

# (P, block, chunk, n_split); n_split None is the split plan
SWEEP = (
    (1, 256, 2048, None),
    (2, 256, 2048, None),
    (4, 256, 2048, None),
    (4, 256, 2048, 1),
    (4, 128, 1024, None),
    (8, 128, 2048, None),
    (2, 512, 1024, None),
    (4, 256, 4096, None),
)
# K5g's kernel at P targets a thread: this tree's ptile_kernel<P> or an
# older build's chunk_kernel<P, false, RowTargets>
KERNEL = r"(?:ptile|chunk)_kernelILi{p}E"


def as_acc(out) -> torch.Tensor:
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def loop_reading(funcs: dict, usage: dict, pattern: str) -> dict:
    """{"sass_per_pair", "loop", "pairs", "registers", "spill_stores",
    "spill_loads"} of the one kernel matching ``pattern``: its largest
    innermost loop's instructions over its MUFU.RSQ (one a pair), and
    its ``-Xptxas -v`` line."""
    name = sass.find(funcs, pattern)
    n, mufu = sass.pair_loop(funcs[name], "MUFU")
    return {"sass_per_pair": n / mufu if mufu else None, "loop": n,
            "pairs": mufu, **usage[name]}


def log_reading(log, label: str, r: dict) -> None:
    log(f"  {label}: pair loop {r['loop']} SASS for {r['pairs']} pairs, "
        f"{r['sass_per_pair']:.2f} a pair; {r['registers']} registers, spill "
        f"{r['spill_stores']} bytes stored, {r['spill_loads']} loaded")


def pair_loops(lib: Path, log=print, label: str = "") -> dict:
    """{P: :func:`loop_reading`} of each K5g kernel in the library (the
    ``.log`` of its build beside it)."""
    funcs = sass.functions(lib)
    usage = sass.ptxas_usage(lib.with_suffix(".log").read_text())
    out = {}
    for p in PS:
        out[p] = loop_reading(funcs, usage, KERNEL.format(p=p))
        log_reading(log, f"{label}ptile_forces P={p}", out[p])
    return out


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    want = as_acc(ptile_acc_plain(tgt, src))
    sms = sm_count(scene.pos.device.index or 0)
    results = []
    for p, block, chunk, n_split in SWEEP:
        splits = n_split or split_plan(scene.n, scene.s128, p, block, chunk, sms)
        blocks = -(-scene.n // (p * block))
        r = _scene.measure(f"p{p}x{block}c{chunk} split {splits}",
                           lambda p=p, block=block, chunk=chunk, n=n_split:
                           ptile_acc(tgt, src, p=p, block=block, chunk=chunk,
                                     n_split=n),
                           as_acc, want, scene, k1_ms, log)
        r["config"] = {"p": p, "block": block, "chunk": chunk,
                       "n_split": splits, "blocks": blocks * splits,
                       "stage": stage(chunk)}
        results.append(r)
    loops = pair_loops(_build.library_path("ptile_forces"), log)
    for r in results:
        r["sass"] = loops[r["config"]["p"]]
    return _scene.finish("K5g", results)


def jobs(n: int = _scene.N, reps: int | None = 20) -> list:
    """One "k5g" job of ``_side.py`` a configuration of the sweep."""
    return [{"what": "k5g", "n": n, "p": p, "block": block, "chunk": chunk,
             "n_split": n_split, "reps": reps}
            for p, block, chunk, n_split in SWEEP]


def in_turns(other: Path, work: list, out: Path) -> tuple[dict, list]:
    """({"old": [turn 0, turn 3], "new": [turn 1, turn 2]} of the jobs'
    times, [(the other side's output, this tree's)] a job): the jobs run
    old, new, new, old, each turn in a process of its own (``_side.py``),
    every kernel built before the first."""
    from .tune_direct import _side_run

    build = {"what": "build",
             "names": sorted(p.stem for p in _build.CSRC.glob("*.cu"))}
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        head = [build] if turn == 0 else []
        res = _side_run(other if who == "old" else ROOT, head + work,
                        out / f"{turn}")
        times[who].append(res[len(head):])
    outputs = [tuple(torch.load(out / t / f"{j}.pt")[0]
                     for t, j in (("0", i + 1), ("1", i)))
               for i in range(len(work))]
    return times, outputs


def compare(times: dict, outputs: list, i: int) -> dict:
    """Job i's row: both sides' ms in turns, new/old, both sides' split,
    and whether the two forces are bit-equal."""
    o, n = ([t[i]["ms"] for t in times[who]] for who in ("old", "new"))
    old, new = outputs[i]
    return {"old": o, "new": n, "ratio": sum(n) / sum(o),
            "n_split": [times[who][0][i]["n_split"] for who in ("old", "new")],
            "equal": _scene.bit_equal(old, new), "rel": _scene.rel(new, old)}


def log_row(log, label: str, row: dict) -> None:
    o, n = row["old"], row["new"]
    log(f"  {label}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, {n[1]:.4f} "
        f"ms; new/old {row['ratio']:.4f}; split old {row['n_split'][0]}, new "
        f"{row['n_split'][1]}; "
        + ("bit-equal" if row["equal"] else
           f"DIFFERENT (max|d|/max|old| {row['rel']:.3e})"))


def old_library(other: Path, name: str) -> Path:
    libs = sorted((other / "build" / "kernels").glob(f"lib{name}-*.so"))
    if len(libs) != 1:
        raise RuntimeError(f"expected one {name} build in {other}, got {libs}")
    return libs[0]


def parent(other: Path, log=print) -> dict:
    from .tune_direct import _card
    from .tune_r2c import sass_against

    log(f"parent on {_card()}: this tree against {other}")
    work = jobs()
    times, outputs = in_turns(other, work, OUT / "parent")
    rows = []
    for i, job in enumerate(work):
        row = {"p": job["p"], "block": job["block"], "chunk": job["chunk"],
               "stage": stage(job["chunk"]), **compare(times, outputs, i)}
        log_row(log, f"K5g p{job['p']}x{job['block']}c{job['chunk']} stage "
                f"{row['stage']}", row)
        rows.append(row)
    sass_old = pair_loops(old_library(other, "ptile_forces"), log, "old ")
    sass_new = pair_loops(_build.library_path("ptile_forces"), log, "new ")
    same = sass_against(other, ("ptile_forces", "flavor_forces"), log)
    return {"configs": rows, "sass_old": sass_old, "sass_new": sass_new,
            "sass_same": same}


# (kernel, P, block, chunk) of ``stages``: K5g's two best configurations
# and K5e's control and fma_kloop at the script's tile 1024
STAGE_CASES = (("K5g", 2, 256, 2048), ("K5g", 4, 256, 4096),
               ("control", 2, 512, 2048), ("fma_kloop", 2, 512, 2048))


def stages(scene: _scene.Scene, log=print) -> list:
    """Each of STAGE_CASES at every stage of 256 to 4096 sources that
    divides its chunk: ms (CUDA events), and the bits against
    :func:`~..ops.ptile_forces.stage`'s."""
    from ..ops import flavor_forces as ff
    from ..ops import ptile_forces as ptf

    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    t, s, dev = scene.n, scene.s128, scene.pos.device
    rows = []
    for name, p, block, chunk in STAGE_CASES:
        if name == "K5g":
            lib, head = ptf._lib().nbody_ptile_forces, (p,)
        else:
            lib, head = ff._lib().nbody_flavor_forces, (ff.FLAVORS[name][0], p)

        def call(sources, lib=lib, head=head, p=p, block=block, chunk=chunk):
            return ptf._launch(lambda *rest: lib(
                tgt.data_ptr(), src.data_ptr(), t, s, *head, block, chunk,
                *rest), t, s, p, block, chunk, None, dev, name, sources)
        want = call(stage(chunk))
        for sources in (256, 512, 1024, 2048, 4096):
            if sources > chunk or chunk % sources:
                continue
            got = call(sources)
            ms = _scene.time_it(lambda sources=sources, call=call: call(sources))
            row = {"kernel": name, "p": p, "block": block, "chunk": chunk,
                   "stage": sources, "ms": ms,
                   "equal": _scene.bit_equal(got, want)}
            log(f"  {name} P={p} x {block} chunk {chunk} stage {sources}: "
                f"{ms:.4f} ms, {'bit-equal' if row['equal'] else 'DIFFERENT'}"
                f" to stage {stage(chunk)}")
            rows.append(row)
    return rows


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
    if argv and argv[0] == "stages":
        from .tune_direct import _card

        scene = _scene.make_scene()
        print(f"stages on {_card()}: N={scene.n} S128={scene.s128}")
        out = stages(scene)
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "stages.json").write_text(json.dumps(out, indent=1))
        if not all(r["equal"] for r in out):
            raise SystemExit("tune_r2g stages: a stage changed the bits")
        return
    n = int(argv[0]) if argv else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5g p-tile", scene))


if __name__ == "__main__":
    main()
