"""K5d on the card: source-stationary force, one source chunk per block in
shared memory, per-chunk partials summed in chunk order.

Counterpart of ``scripts/ablations/tune_r2d.py``. The script's
(tile_t, chunk) list becomes (block, chunk): ``block`` targets per tile
walked by a block (two a thread from 64 on, :func:`..ops.stationary_forces.shape`),
``chunk`` sources resident in its shared memory. Blocks walk slabs of the
target tiles so that few chunks still fill the card; one configuration
also runs the pure form (one slab: every block walks every tile). The
script's ``manual_reduce`` has no counterpart (a thread sums serially), so
its one manual configuration is not repeated.

    python -m nbody_tpu_torch.ablations.tune_r2d [N]
    python -m nbody_tpu_torch.ablations.tune_r2d slabs
    python -m nbody_tpu_torch.ablations.tune_r2d parent DIR

``slabs`` times each (block, chunk) of the sweep on the N=65536 scene at
slab counts from 1 to one slab a tile (doubling; the plan's own marked),
rsqrt and precise, the best of two.

``parent`` times the sweep against another commit of the port, whose
package DIR holds (``git archive <commit> nbody_tpu_torch | tar -x -C
DIR``): each side in a process of its own through its public wrapper
(``stationary_forces.stationary_acc``, ``_side.py``'s "k5d" job; ``block``
is targets a tile in both), in turns (old, new, new, old) on the N=65536
scene, every configuration on the rsqrt and the precise path; each
configuration's bits against the other side's; this tree's pair loop
(SASS a pair, ``pair_loops``); and whether every other
kernel of the other commit compiled to the same SASS here
(``tune_r2c.sass_against``). JSON goes to ``build/tune_r2d/``. Without a
CUDA device either form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops.direct_forces import sm_count
from ..ops.stationary_forces import (shape, slab_plan, stationary_acc,
                                     stationary_acc_plain)
from ..types import round_up
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2d"

# (block, chunk, slabs); block is targets a tile, slabs None the slab plan
SWEEP = (
    (256, 128, None),
    (256, 256, None),
    (256, 256, 1),
    (256, 512, None),
    (256, 1024, None),
    (256, 2048, None),
    (512, 512, None),
    (512, 1024, None),
    (1024, 512, None),
    (128, 512, None),
)


def pair_loops(log=print) -> dict:
    """{P: SASS a pair} of the rsqrt kernel's pair loop (the largest
    innermost loop over its MUFU.RSQ, one a pair) at P = 1 and 2, in the
    built library."""
    funcs = sass.functions(_build.build_all(["stationary_forces"])
                           ["stationary_forces"][0])
    out = {}
    for p in (1, 2):
        name = sass.find(funcs, rf"stationary_kernelILi{p}ELb0E")
        n, mufu = sass.pair_loop(funcs[name], "MUFU")
        out[p] = n / mufu
        log(f"  stationary_forces P={p}: pair loop {n} SASS instructions for "
            f"{mufu} pairs, {n / mufu:.2f} a pair")
    return out


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Every configuration of SWEEP against its plain version, twice for
    bit-equality, timed; then the pair loop's SASS a pair."""
    tgt = scene.tgt3()
    sms = sm_count(scene.pos.device.index or 0)
    results = []
    for block, chunk, slabs in SWEEP:
        s_pad = round_up(scene.mass_len, chunk)
        src = scene.src3(s_pad)
        want = stationary_acc_plain(tgt, src, chunk=chunk).T
        n_slabs = slabs or slab_plan(scene.n, s_pad, block, chunk, sms)
        p, threads = shape(block)
        r = _scene.measure(f"k3({block}x{chunk}) slabs {n_slabs}",
                           lambda block=block, chunk=chunk, slabs=slabs, src=src:
                           stationary_acc(tgt, src, block=block, chunk=chunk,
                                          slabs=slabs),
                           lambda a: a.T,
                           want, scene, k1_ms, log)
        r["config"] = {"block": block, "chunk": chunk, "slabs": n_slabs,
                       "p": p, "threads": threads,
                       "s_pad": s_pad, "blocks": (s_pad // chunk) * n_slabs,
                       "partial_mb": (s_pad // chunk) * scene.n * 8 / 1e6}
        log(f"  {'':>24}  P={p} x {threads} threads, dead source rows "
            f"{s_pad - scene.mass_len}, {r['config']['blocks']} blocks, "
            f"partials {r['config']['partial_mb']:.1f} MB")
        results.append(r)
    sass_a_pair = pair_loops(log)
    for r in results:
        r["sass_per_pair"] = sass_a_pair[r["config"]["p"]]
    return _scene.finish("K5d", results)


def jobs(n: int = _scene.N, reps: int | None = 20) -> list:
    """One "k5d" job of ``_side.py`` a configuration and path."""
    return [{"what": "k5d", "n": n, "block": block, "chunk": chunk,
             "slabs": slabs, "precise": precise, "reps": reps}
            for precise in (False, True) for block, chunk, slabs in SWEEP]


def parent(other: Path, log=print) -> dict:
    from .tune_direct import _card, _side_run
    from .tune_r2c import sass_against

    log(f"parent on {_card()}: this tree against {other}")
    work = jobs()
    build = {"what": "build",
             "names": sorted(p.stem for p in _build.CSRC.glob("*.cu"))}
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        head = [build] if turn == 0 else []
        res = _side_run(other if who == "old" else ROOT, head + work,
                        OUT / "parent" / f"{turn}")
        times[who].append(res[len(head):])
    rows = []
    for i, job in enumerate(work):
        o, n = ([t[i]["ms"] for t in times[who]] for who in ("old", "new"))
        (old,), (new,) = (torch.load(OUT / "parent" / t / f"{j}.pt")
                          for t, j in (("0", i + 1), ("1", i)))
        row = {"block": job["block"], "chunk": job["chunk"],
               "slabs": times["new"][0][i]["slabs"], "precise": job["precise"],
               "old": o, "new": n, "ratio": sum(n) / sum(o),
               "equal": _scene.bit_equal(old, new), "rel": _scene.rel(new, old)}
        log(f"  K5d block {row['block']:>4} chunk {row['chunk']:>4} slabs "
            f"{row['slabs']:>3} {'precise' if row['precise'] else 'rsqrt  '}: "
            f"old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, {n[1]:.4f} ms; "
            f"new/old {row['ratio']:.4f}; bits "
            f"{'equal' if row['equal'] else 'DIFFERENT'} (max|d|/max|old| "
            f"{row['rel']:.3e})")
        rows.append(row)
    best = {}
    for precise, path in ((False, "rsqrt"), (True, "precise")):
        for who in ("old", "new"):
            b = min((r for r in rows if r["precise"] == precise),
                    key=lambda r: min(r[who]))
            best[f"{who} {path}"] = {"block": b["block"], "chunk": b["chunk"],
                                     "ms": b[who]}
        log(f"  best {path}: old {best['old ' + path]} -> new "
            f"{best['new ' + path]}")
    new_sass = pair_loops(log)
    same = sass_against(other, ("stationary_forces",), log)
    return {"configs": rows, "best": best, "new_sass_a_pair": new_sass,
            "sass_same": same}


def slabs(scene: _scene.Scene, log=print) -> list:
    """ms of each (block, chunk) of SWEEP, rsqrt and precise, at 1, 2, 4,
    ... slabs up to one a tile, and at the slab plan's count."""
    tgt = scene.tgt3()
    sms = sm_count(torch.cuda.current_device())
    rows = []
    for block, chunk in dict.fromkeys((b, c) for b, c, _ in SWEEP):
        src = scene.src3(round_up(scene.mass_len, chunk))
        tiles = -(-scene.n // block)
        plan = slab_plan(scene.n, src.shape[-1], block, chunk, sms)
        counts = sorted({plan, tiles, *(1 << k for k in range(tiles.bit_length())
                                       if 1 << k <= tiles)})
        for precise in (False, True):
            ms = {k: min(_scene.time_it(lambda k=k: stationary_acc(
                tgt, src, block=block, chunk=chunk, slabs=k, precise=precise))
                for _ in range(2)) for k in counts}
            best = min(ms, key=ms.get)
            log(f"  block {block} chunk {chunk} "
                f"{'precise' if precise else 'rsqrt'}: "
                + ", ".join(f"{k}{'*' if k == plan else ''} {t:.4f}"
                            for k, t in ms.items())
                + f"; best {best} slabs, {ms[best] / ms[plan]:.4f}x the plan's")
            rows.append({"block": block, "chunk": chunk, "precise": precise,
                         "plan": plan, "ms": {str(k): t for k, t in ms.items()}})
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
    if argv and argv[0] == "slabs":
        from .tune_direct import _card

        scene = _scene.make_scene()
        print(f"slabs on {_card()}: N={scene.n} mass_len={scene.mass_len}; "
              f"ms a call at k slabs (* the plan's)")
        out = slabs(scene)
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "slabs.json").write_text(json.dumps(out, indent=1))
        return
    n = int(argv[0]) if argv else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5d source-stationary", scene))


if __name__ == "__main__":
    main()
