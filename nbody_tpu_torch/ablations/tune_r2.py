"""K5a on the card: force only over chunks of resident sources, swept over
tile and chunk, each also timed as a 50-substep Euler loop.

Counterpart of ``scripts/ablations/tune_r2.py`` (the ``v2_resident``
variants). The kernel is K5b's, ``csrc/v2_forces.cu`` in the column layout
(:mod:`..ops.resident_forces`, runs of 256 sources summed apart): the
script's tile_t targets a block, two a thread (``v2_forces.shape``), and
chunk the sources staged through shared memory per pass. The script swept tile_t in (512, 1024, 2048) and chunk in
(512, 1024, 2048, 4096); here the tiles are 256, 512 and 1024 (128, 256 and
512 threads): tile 2048 would need 1024 threads at P = 2, over the
kernel's 512-thread cap. Every configuration is held to the plain direct
sum on the rsqrt path and the precise one (``gm / (sqrt(r2) * r2)``). The
script's v0 and v1 variants were K1 with other source paddings; K1's
``force_acc`` is the line every configuration is compared with, and the
World's fused substep the one the loop is compared with.

    python -m nbody_tpu_torch.ablations.tune_r2 [N]
    python -m nbody_tpu_torch.ablations.tune_r2 parent DIR

``parent`` times K5a against another commit of the port, whose package DIR
holds (``git archive <commit> nbody_tpu_torch | tar -x -C DIR``): each side
in a process of its own through its public wrapper
(``resident_forces.v2_acc``, ``_side.py``'s "k5a" job), in turns (old,
new, new, old) on the N=65536 scene, at the tiles of both sides' sweeps
(``block`` is targets a block in both), each at its own split plan; each
configuration's bits against the other side's, this tree unsplit (as K5a
ran before its source split); K5b's eight configurations bit for bit (``_side.py``'s
"v2" job); and whether every kernel of the other commit's builds, K5i's
aside, compiled to the same SASS in this tree (``ops/sass.diff``). JSON
goes to ``build/tune_r2/``. Without a CUDA device either form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops import resident_forces as rsf
from ..ops.resident_forces import v2_acc, v2_acc_plain
from ..world import create_world
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2"

TILES = (256, 512, 1024)
CHUNKS = (512, 1024, 2048, 4096)
SWEEP = tuple((tile, chunk) for tile in TILES for chunk in CHUNKS)
PARENT_TILES = (128, 256, 512)   # the sweep before K5a ran on v2_forces.cu
SUBSTEPS = 50     # the script's fused substeps per timed call
DT = 0.001


def time_substeps(step, state, iters: int = SUBSTEPS, repeats: int = 3) -> float:
    """Milliseconds per substep of ``iters`` calls of step: state -> state
    from ``state``, best of ``repeats`` after one warm-up loop (the
    script's ``time_substeps``)."""
    def loop():
        s = state
        for _ in range(iters):
            s = step(s)
        return s

    return _scene.time_it(loop, reps=1, repeats=repeats) / iters


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Every configuration of SWEEP against the plain version (once per
    scene and path), twice for bit-equality, timed force-only and as the
    loop; the precise path checked and timed too."""
    n, s128 = scene.n, scene.s128
    src = scene.src3(s128)
    want = {precise: v2_acc_plain(scene.pos, scene.radius, src, precise=precise)
            for precise in (False, True)}
    valid = torch.ones((n, 1), dtype=torch.float32, device=scene.pos.device)
    world = create_world(scene.particles, device=scene.pos.device)
    world_ms = _scene.time_it(lambda: world.update(DT, SUBSTEPS), reps=1) / SUBSTEPS
    log(f"  World.update (fused kernel, euler): {world_ms * 1e3:.1f} µs/substep "
        f"over {SUBSTEPS} substeps")
    results = []
    for tile, chunk in SWEEP:
        p, threads = rsf.shape(tile, chunk)

        def acc(p=scene.pos, s=src, tile=tile, chunk=chunk, precise=False):
            return v2_acc(p, scene.radius, s, block=tile, chunk=chunk,
                          precise=precise)

        def step(state, acc=acc):
            p, v = state
            a = acc(p, scene.src3(s128, p)) * valid
            v = v + DT * a
            return p + DT * v, v

        name = f"v2_resident({tile}x{chunk})"
        r = _scene.measure(f"{name} p{p}x{threads}", acc, lambda a: a,
                           want[False], scene, k1_ms, log)
        r["precise"] = _scene.measure(
            f"{name} precise", lambda acc=acc: acc(precise=True), lambda a: a,
            want[True], scene, k1_ms, log)
        r["ok"] = r["ok"] and r["precise"]["ok"]
        r["config"] = {"block": tile, "chunk": chunk, "p": p,
                       "threads": threads}
        r["substep_ms"] = time_substeps(step, (scene.pos, scene.world.state.vel))
        r["world_ms"] = world_ms
        log(f"  {'':>24}  {SUBSTEPS}-substep loop (force, mask, Euler): "
            f"{r['substep_ms'] * 1e3:.1f} µs/substep, "
            f"{r['substep_ms'] / world_ms:.3f}x World.update")
        results.append(r)
    return _scene.finish("K5a", results)


def jobs(tiles, n: int = _scene.N, n_split: int | None = None,
         reps: int | None = 20) -> list:
    """One "k5a" job of ``_side.py`` a tile, chunk and path."""
    split = {"n_split": n_split} if n_split else {}
    return [{"what": "k5a", "n": n, "block": tile, "chunk": chunk,
             "precise": precise, "reps": reps, **split}
            for precise in (False, True) for tile in tiles for chunk in CHUNKS]


def parent(other: Path, log=print) -> dict:
    from . import tune_r2b
    from .tune_direct import _card, _side_run

    log(f"parent on {_card()}: this tree against {other}")
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    # the other commit's builds of every kernel this tree has, K5i's aside
    build = {"what": "build", "names": [m for m in names if m != "bcast_probe"]}
    k5b = [dict(j, reps=None) for j in tune_r2b.jobs()]
    old_jobs, new_jobs = jobs(PARENT_TILES), jobs(sorted({*PARENT_TILES, *TILES}))
    # this tree unsplit at the other's tiles, as the other ran them
    bits = jobs(PARENT_TILES, n_split=1, reps=None)
    first = {"old": k5b + [build], "new": k5b + bits}
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        head = first[who] if turn < 2 else []
        res = _side_run(other if who == "old" else ROOT,
                        head + (old_jobs if who == "old" else new_jobs),
                        OUT / "parent" / f"{turn}")
        times[who].append(res[len(head):])

    def key(job):
        return job["block"], job["chunk"], job["precise"]

    old_at = {key(j): i for i, j in enumerate(old_jobs)}
    rows = []
    for k, job in enumerate(new_jobs):
        i = old_at.get(key(job))
        o = [t[i]["ms"] for t in times["old"]] if i is not None else []
        n = [t[k]["ms"] for t in times["new"]]
        row = {"block": job["block"], "chunk": job["chunk"],
               "precise": job["precise"], "old": o, "new": n}
        text = ""
        if i is not None:
            (old,), (new,) = (torch.load(OUT / "parent" / t / f"{j}.pt")
                              for t, j in (("0", len(first["old"]) + i),
                                           ("1", len(k5b) + i)))
            row.update(ratio=sum(n) / sum(o), equal=_scene.bit_equal(old, new),
                       rel=_scene.rel(new, old))
            text = (f"; new/old {row['ratio']:.4f}; unsplit, bits "
                    f"{'equal' if row['equal'] else 'DIFFERENT'} "
                    f"(max|d|/max|old| {row['rel']:.3e})")
        log(f"  K5a tile {row['block']:>4} chunk {row['chunk']:>4} "
            f"{'precise' if row['precise'] else 'rsqrt  '}: old "
            + (", ".join(f"{t:.4f}" for t in o) or "-")
            + "; new " + ", ".join(f"{t:.4f}" for t in n) + " ms" + text)
        rows.append(row)
    best = {}
    for precise, path in ((False, "rsqrt"), (True, "precise")):
        for who, tiles in (("old", PARENT_TILES), ("new", TILES)):
            b = min((r for r in rows if r["precise"] == precise
                     and r["block"] in tiles), key=lambda r: min(r[who]))
            best[f"{who} {path}"] = {"block": b["block"], "chunk": b["chunk"],
                                     "ms": b[who]}
        log(f"  best {path} of each sweep: old {best['old ' + path]} -> new "
            f"{best['new ' + path]}")
    k5b_equal = []
    for i in range(len(k5b)):
        (old,), (new,) = (torch.load(OUT / "parent" / t / f"{i}.pt")
                          for t in ("0", "1"))
        k5b_equal.append(_scene.bit_equal(old, new))
    log(f"  K5b's eight configurations bit-equal to the other commit's: "
        f"{sum(k5b_equal)} of {len(k5b_equal)}")
    mine = {name: path for name, (path, _) in _build.build_all(names).items()}
    same = {}
    for name in build["names"]:
        theirs = sorted((other / "build" / "kernels").glob(f"lib{name}-*.so"))
        if len(theirs) != 1:
            raise RuntimeError(f"expected one {name} build in {other}, got {theirs}")
        # the other commit's kernels, each in this tree's build
        same[name] = sass.diff(theirs[0], mine[name])
        log(f"  {name}: {sum(same[name].values())} of {len(same[name])} of "
            f"the other commit's kernels compiled to the same SASS here"
            + ("" if all(same[name].values()) else
               f"; DIFFERENT: {[k for k, v in same[name].items() if not v]}"))
    return {"configs": rows, "best": best, "k5b_equal": k5b_equal,
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
    run(scene, _scene.header("K5a v2_resident", scene))


if __name__ == "__main__":
    main()
