"""K5b on the card: the script's eight micro-variants of the resident-source
kernel, each against its plain version and as a 50-substep Euler loop.

Counterpart of ``scripts/ablations/tune_r2b.py``, whose ``make_v2`` ran
K5a's kernel with targets as columns (``kernel_cols``: flavors base,
partial, static, and ``unroll=2``) or as a (3, tile) row block
(``kernel_rows``). Here each is a variant of ``csrc/v2_forces.cu``
(:mod:`..ops.v2_forces` maps the flavors): the column layout takes (T, 2)
positions and a (T,) radius, the row layout (3, T) rows; the script's
tile_t is P targets per thread times a block of threads (P = 2 from tile
256 on). Each configuration also runs as the script's loop: 50 substeps of
force, the ``valid`` mask and Euler, the sources rebuilt from the new
positions each substep, beside ``World.update``.

    python -m nbody_tpu_torch.ablations.tune_r2b [N]
    python -m nbody_tpu_torch.ablations.tune_r2b split
    python -m nbody_tpu_torch.ablations.tune_r2b parent DIR

``split`` times each configuration of the sweep on the N=65536 scene at
every source split from 1 range to one range a chunk (``v2_acc``'s
``n_split``; the plan's own marked), the best of two.

``parent`` times the sweep against another commit of the port, whose
package DIR holds (``git archive <commit> nbody_tpu_torch | tar -x -C
DIR``): each side in a process of its own through its public wrappers
(``_side.py``'s "v2" job: ``v2_forces.v2_acc`` where the tree has it, else
``flavor_forces.flavor_acc``), the sides in turns (old, new, new, old) on
the N=65536 scene; each configuration's bits against the other side's;
the pair loop of each side's kernels (SASS a pair); and whether K5c's and
K5e's kernels in ``csrc/flavor_forces.cu`` compiled to the same code in
both (``ops/sass.diff``). Both write JSON to ``build/tune_r2b/``.
Without a CUDA device either form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops.direct_forces import sm_count
from ..ops.ptile_forces import split_plan
from ..ops import v2_forces as v2
from ..ops.flavor_forces import as_acc
from ..ops.v2_forces import plain_key, shape, v2_acc, v2_acc_plain
from ..world import create_world
from . import _scene
from .tune_direct import _card, _side_run
from .tune_r2 import DT, SUBSTEPS, time_substeps

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2b"

# (script's name, flavor, rows, tile_t, chunk): tune_r2b.py:206-213
SWEEP = (
    ("v2_base(512x2048)", "base", False, 512, 2048),
    ("v2_rows(512x2048)", "rows", True, 512, 2048),
    ("v2_partial(512x2048)", "partial", False, 512, 2048),
    ("v2_unroll2(512x2048)", "unroll2", False, 512, 2048),
    ("v2_static(512x2048)", "static", False, 512, 2048),
    ("v2_rows(512x1024)u2", "unroll2", True, 512, 1024),
    ("v2_rows(1024x1024)", "rows", True, 1024, 1024),
    ("v2_rows(256x2048)", "rows", True, 256, 2048),
)
# the variant of each flavor in the kernels' names: (unroll, lanes)
KERNEL_ARGS = {"base": (1, 0), "unroll2": (2, 0), "static": (4, 0),
               "partial": (1, 1)}


def targets(scene: _scene.Scene, rows: bool, pos: torch.Tensor | None = None):
    """The scene's targets in a layout: (3, N) rows or (pos, radius)."""
    pos = scene.pos if pos is None else pos
    if not rows:
        return pos, scene.radius
    return torch.stack([pos[:, 0], pos[:, 1], scene.radius])


def pair_loops(funcs: dict, usage: dict, log=print) -> dict:
    """{(flavor, p): (SASS a pair, registers, spill bytes stored)} of the
    row kernels of ``csrc/v2_forces.cu`` (the column layout's loop differs
    only in its target loads): the largest innermost loop over its MUFU.RSQ,
    one a pair, and the build's ``-Xptxas -v`` lines."""
    out = {}
    for flavor, (unroll, lanes) in KERNEL_ARGS.items():
        for p in v2.PS:
            name = sass.find(funcs, rf"v2_kernelILi{p}E.*RowTargetsELi"
                                    rf"{unroll}ELb{lanes}E")
            n, mufu = sass.pair_loop(funcs[name], "MUFU")
            if not mufu:
                raise RuntimeError(f"no pair loop found in {name}")
            u = usage[name]
            out[flavor, p] = (n / mufu, u["registers"], u["spill_stores"])
            log(f"  v2_forces {flavor:>8} P={p}: pair loop {n} SASS "
                f"instructions for {mufu} pairs, {n / mufu:.2f} a pair; "
                f"{u['registers']} registers, spill {u['spill_stores']} "
                f"bytes stored, {u['spill_loads']} loaded")
    return out


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Every configuration of SWEEP against its plain version (once per
    distinct plain function), twice for bit-equality, timed force-only and
    as the loop; each result counts the kernel launches it made."""
    n, s128 = scene.n, scene.s128
    src = scene.src3(s128)
    valid = torch.ones((n, 1), dtype=torch.float32, device=scene.pos.device)
    world = create_world(scene.particles, device=scene.pos.device)
    world_ms = _scene.time_it(lambda: world.update(DT, SUBSTEPS), reps=1) / SUBSTEPS
    log(f"  World.update (fused kernel, euler): {world_ms * 1e3:.1f} µs/substep "
        f"over {SUBSTEPS} substeps")
    plains, results = {}, []
    for name, flavor, rows, tile_t, chunk in SWEEP:
        p, block = shape(tile_t)

        def acc(pos=None, s=src, flavor=flavor, rows=rows, p=p, block=block,
                chunk=chunk):
            return v2_acc(targets(scene, rows, pos), s, flavor=flavor, p=p,
                          block=block, chunk=chunk)

        def step(state, acc=acc):
            pos, vel = state
            a = as_acc(acc(pos, scene.src3(s128, pos))) * valid
            vel = vel + DT * a
            return pos + DT * vel, vel

        key = plain_key(flavor, chunk)
        if key not in plains:
            plains[key] = as_acc(v2_acc_plain(targets(scene, rows), src,
                                              flavor=flavor, chunk=chunk))
        before = v2.LAUNCHES
        r = _scene.measure(f"{name} p{p}x{block}", acc, as_acc, plains[key],
                           scene, k1_ms, log)
        r["config"] = {"flavor": flavor, "rows": rows, "tile_t": tile_t,
                       "p": p, "block": block, "chunk": chunk}
        r["substep_ms"] = time_substeps(step, (scene.pos, scene.world.state.vel))
        r["world_ms"] = world_ms
        r["launches"] = v2.LAUNCHES - before
        log(f"  {'':>24}  {SUBSTEPS}-substep loop (force, mask, Euler): "
            f"{r['substep_ms'] * 1e3:.1f} µs/substep, "
            f"{r['substep_ms'] / world_ms:.3f}x World.update")
        results.append(r)
    return _scene.finish("K5b", results)


def jobs(n: int = _scene.N) -> list:
    """One "v2" job of ``_side.py`` a configuration of SWEEP."""
    return [{"what": "v2", "n": n, "flavor": flavor, "rows": rows,
             "tile_t": tile_t, "chunk": chunk, "reps": 20}
            for _, flavor, rows, tile_t, chunk in SWEEP]


def old_pair_loops(lib: Path, log=print) -> dict:
    """{flavor: SASS a pair} of K5b's kernels in an older build of
    ``csrc/flavor_forces.cu`` (variants 0-3 at P = 1 on row targets)."""
    funcs = sass.functions(lib)
    out = {}
    for flavor, variant in (("base", 0), ("unroll2", 1), ("static", 2),
                            ("partial", 3)):
        name = sass.find(funcs, rf"flavor_kernelILi1E.*RowTargetsELi{variant}EE")
        n, mufu = sass.pair_loop(funcs[name], "MUFU")
        out[flavor] = n / mufu
        log(f"  old flavor_forces {flavor:>8} P=1: pair loop {n} SASS "
            f"instructions for {mufu} pairs, {n / mufu:.2f} a pair")
    return out


def parent(other: Path, log=print) -> dict:
    log(f"parent on {_card()}: this tree against {other}")
    work = jobs()
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        res = _side_run(other if who == "old" else ROOT, work,
                        OUT / "parent" / f"{turn}")
        times[who].append(res)
    rows = []
    for i, (name, *_rest) in enumerate(SWEEP):
        o, n = ([r[i]["ms"] for r in times[who]] for who in ("old", "new"))
        (old,), (new,) = (torch.load(OUT / "parent" / t / f"{i}.pt")
                          for t in ("0", "1"))
        eq = _scene.bit_equal(old, new)
        row = {"what": name, "old": o, "new": n, "ratio": sum(n) / sum(o),
               "equal": eq, "rel": _scene.rel(new, old),
               "old_p": times["old"][0][i]["p"], "new_p": times["new"][0][i]["p"]}
        log(f"  {name}: old P={row['old_p']} {o[0]:.4f}, {o[1]:.4f}; new "
            f"P={row['new_p']} {n[0]:.4f}, {n[1]:.4f} ms; new/old "
            f"{row['ratio']:.4f}; bits {'equal' if eq else 'DIFFERENT'} "
            f"(max|d|/max|old| {row['rel']:.3e})")
        rows.append(row)
    for rows_layout in (False, True):
        mine = [r for r, c in zip(rows, SWEEP) if c[2] == rows_layout]
        best = {who: min(min(r[who]) for r in mine) for who in ("old", "new")}
        log(f"  best {'rows' if rows_layout else 'cols'}: old {best['old']:.4f}"
            f" -> new {best['new']:.4f} ms")
    mine = {name: _build.build_all([name])[name][0]
            for name in ("v2_forces", "flavor_forces")}
    theirs = sorted((other / "build" / "kernels").glob("libflavor_forces-*.so"))
    if len(theirs) != 1:
        raise RuntimeError(f"expected one flavor_forces build in {other}, "
                           f"got {theirs}")
    same = sass.diff(mine["flavor_forces"], theirs[0])
    log(f"  flavor_forces.cu, this tree against the other: {sum(same.values())} "
        f"of {len(same)} kernels compiled to the same SASS"
        + ("" if all(same.values()) else
           f"; DIFFERENT: {[k for k, v in same.items() if not v]}"))
    usage = sass.ptxas_usage(mine["v2_forces"].with_suffix(".log").read_text())
    new_loops = pair_loops(sass.functions(mine["v2_forces"]), usage, log)
    return {"configs": rows, "sass_same": same,
            "old_sass_a_pair": old_pair_loops(theirs[0], log),
            "new_sass_a_pair": {f"{f} P={p}": v[0]
                                for (f, p), v in new_loops.items()}}


def split(scene: _scene.Scene, log=print) -> list:
    """ms of each configuration of SWEEP at each number of source ranges
    that gives ranges of a distinct length, and the plan's own."""
    src = scene.src3(scene.s128)
    sms = sm_count(torch.cuda.current_device())
    rows = []
    for name, flavor, rows_layout, tile_t, chunk in SWEEP:
        p, block = shape(tile_t)
        tgt = targets(scene, rows_layout)
        chunks = -(-scene.s128 // chunk)
        plan = split_plan(scene.n, scene.s128, p, block, chunk, sms)
        # the distinct range counts: n ranges of ceil(chunks / n) chunks
        ns = sorted({-(-chunks // -(-chunks // n)) for n in range(1, chunks + 1)})
        ms = {}
        for n in ns:
            ms[n] = min(_scene.time_it(lambda n=n: v2_acc(
                tgt, src, flavor=flavor, p=p, block=block, chunk=chunk,
                n_split=n)) for _ in range(2))
        best = min(ms, key=ms.get)
        log(f"  {name} p{p}x{block} ({chunks} chunks): "
            + ", ".join(f"{n}{'*' if n == plan else ''} {t:.4f}"
                        for n, t in ms.items())
            + f"; best {best} ranges, {ms[best] / ms[plan]:.4f}x the plan's")
        rows.append({"what": name, "chunks": chunks, "plan": plan,
                     "ms": {str(n): t for n, t in ms.items()}})
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
    if argv and argv[0] == "split":
        scene = _scene.make_scene()
        print(f"split on {_card()}: N={scene.n} S128={scene.s128}; ms a call "
              f"at n source ranges (* the plan's)")
        out = split(scene)
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "split.json").write_text(json.dumps(out, indent=1))
        return
    n = int(argv[0]) if argv else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5b v2 micro-variants", scene))


if __name__ == "__main__":
    main()
