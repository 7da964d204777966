"""K5h on the card: force only with Newton's third law over the massive
prefix, each massive x massive tile pair computed once.

Counterpart of ``scripts/ablations/tune_r2h.py``. The script's tile_t in
(512, 1024, 256) becomes the tile width W in (128, 256, 512), two targets
a thread; its source chunk (fchunk) has no counterpart, since the dual
blocks go tile by tile, as items of a task list
(:func:`..ops.newton_forces.newton_schedule`). The script's kernel is
right only where the full massive tiles fill whole chunks;
:func:`check_direct` holds this one to the plain direct sum at a ragged
shape too (mass_len not a whole number of tiles, N not a whole number of
tiles).

    python -m nbody_tpu_torch.ablations.tune_r2h [N]
    python -m nbody_tpu_torch.ablations.tune_r2h plan
    python -m nbody_tpu_torch.ablations.tune_r2h parent DIR

``plan`` prints, for each W at N=65536, the task list (tasks, massive and
forward-only, items a task, teams a block, the heaviest and lightest task
in source steps), its scratch, and the blocks, warps and waves an SM from
the build's registers and shared memory; then a call's device ms in each
of its two kernels (a torch.profiler window). ``parent`` times the sweep
against another commit of the port, whose package DIR holds (``git
archive <commit> nbody_tpu_torch | tar -x -C DIR``): each side in a
process of its own through its public wrapper (``_side.py``'s "k5h"
job), in turns (old, new, new, old) on the N=65536 scene; the rows past
the whole massive tiles bit for bit against the other side's, and each
side's massive rows against the plain direct sum; each side's dual and
forward loops in SASS a pair, with registers and spills; and whether every
other kernel of the other commit compiled to the same SASS here
(``tune_r2c.sass_against``). JSON goes to ``build/tune_r2h/``. Without a
CUDA device each form raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ..ops import _build, sass
from ..ops.newton_forces import (group, newton_acc, newton_acc_plain,
                                 newton_pairs, newton_schedule, scratch_sizes,
                                 smem_bytes, task_cost, teams)
from . import _scene

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_r2h"

SWEEP = (128, 256, 512)
# An H100 SM: registers, shared memory (less 1 KB a block), blocks, warps.
SM_REGISTERS, SM_SMEM, SM_BLOCKS, SM_WARPS = 65536, 233472, 32, 64


def as_acc(out) -> torch.Tensor:
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def pair_loops(lib: Path, log=print, label: str = "") -> dict:
    """{W: {"dual": SASS a dual pair, "forward": SASS a forward pair,
    "registers", "spill_stores"}} of the library's ``newton_kernel<W>``:
    the largest innermost loop that holds a SHFL (the dual step, two
    MUFU.RSQ a pair) and the largest that holds MUFU.RSQ but no SHFL (a
    forward loop, one a pair), and the build's ``-Xptxas -v`` lines (the
    ``.log`` beside the library)."""
    funcs = sass.functions(lib)
    usage = sass.ptxas_usage(lib.with_suffix(".log").read_text())
    out = {}
    for w in SWEEP:
        name = sass.find(funcs, rf"newton_kernelILi{w}E")
        code = funcs[name]
        found = {}
        for first, last, n in sass.innermost(sass.loops(code)):
            ops = [i.split()[1] if i.startswith("@") else i.split()[0]
                   for a, i in code if first <= a <= last]
            mufu = sum(op.startswith("MUFU") for op in ops)
            kind = "dual" if any(op.startswith("SHFL") for op in ops) else "forward"
            pairs = mufu / 2 if kind == "dual" else mufu
            if mufu and n > found.get(kind, (0, 1))[0]:
                found[kind] = (n, pairs)
        u = usage[name]
        out[w] = {k: n / pairs for k, (n, pairs) in found.items()}
        out[w].update(registers=u["registers"], spill_stores=u["spill_stores"])
        log(f"  {label}newton_forces W={w}: "
            + "; ".join(f"{k} loop {n} SASS for {pairs:g} pairs, "
                        f"{n / pairs:.2f} a pair" for k, (n, pairs) in found.items())
            + f"; {u['registers']} registers, spill {u['spill_stores']} "
              f"bytes stored, {u['spill_loads']} loaded")
    return out


def plan(t: int, mass_len: int, s: int, sms: int, log=print) -> dict:
    """{W: the plan's numbers} at T = t, M = mass_len, S = s: tasks (and
    how many are massive), items a task and teams a block, the heaviest and
    lightest task in source steps, scratch MB, and the blocks, warps and
    waves an SM from the build's registers and shared memory."""
    lib = _build.build_all(["newton_forces"])["newton_forces"][0]
    funcs = sass.functions(lib)
    usage = sass.ptxas_usage(lib.with_suffix(".log").read_text())
    out = {}
    for w in SWEEP:
        tasks = newton_schedule(t, mass_len, s, w)
        costs = [task_cost(k, w) for k in tasks]
        regs = usage[sass.find(funcs, rf"newton_kernelILi{w}E")]["registers"]
        smem = smem_bytes(w)
        blocks = min(SM_BLOCKS, SM_WARPS // 8,
                     SM_REGISTERS // (-(-regs // 8) * 8 * 256),
                     SM_SMEM // (smem + 1024))
        sizes = scratch_sizes(t, mass_len, s, w)
        row = {"tasks": len(tasks),
               "massive": sum(k.tile < mass_len // w for k in tasks),
               "group": group(w), "teams": teams(w),
               "heaviest": max(costs, default=0), "lightest": min(costs, default=0),
               "scratch_mb": {k: v * 8 / 1e6 for k, v in sizes.items()},
               "registers": regs, "smem_kb": smem / 1024,
               "blocks_per_sm": blocks, "warps_per_sm": 8 * blocks,
               "waves": len(tasks) / (blocks * sms)}
        log(f"  plan W={w}: {row['tasks']} tasks ({row['massive']} massive), "
            f"{row['group']} items a task, {row['teams']} teams of {w // 2} "
            f"threads; heaviest {row['heaviest']:.0f} source steps, lightest "
            f"{row['lightest']:.0f}; scratch "
            + ", ".join(f"{k} {v:.1f}" for k, v in row["scratch_mb"].items())
            + f" MB; {regs} registers, {row['smem_kb']:.0f} KB shared: "
              f"{blocks} blocks, {8 * blocks} warps an SM, {row['waves']:.1f} "
              f"waves on {sms} SMs")
        out[w] = row
    return out


def split(scene: _scene.Scene, calls: int = 5, log=print) -> dict:
    """{W: {"tasks_ms", "sums_ms"}}: a call's device ms in its two kernels
    (the task list, then the fixed-order sums), from a torch.profiler
    window over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tgt, src = scene.tgt4(), scene.src4(scene.s128)
    out = {}
    for w in SWEEP:
        newton_acc(tgt, src, scene.mass_len, tile=w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                newton_acc(tgt, src, scene.mass_len, tile=w)
            torch.cuda.synchronize()
        ms = {"tasks_ms": 0.0, "sums_ms": 0.0}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = ("sums_ms" if "newton_reduce_kernel" in e.name else
                       "tasks_ms" if "newton_kernel" in e.name else None)
                if key:
                    ms[key] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        log(f"  W={w}: the tasks {ms['tasks_ms']:.4f} ms, the sums "
            f"{ms['sums_ms']:.4f} ms a call (profiler, {calls} calls)")
        out[w] = ms
    return out


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt4(), scene.src4(scene.s128)
    results = []
    for tile in SWEEP:
        want = as_acc(newton_acc_plain(tgt, src, scene.mass_len, tile=tile))
        # the N x mass_len pairs the force needs; the gm = 0 rows that pad
        # the sources to S128 are not counted
        fwd, dual = newton_pairs(scene.n, scene.mass_len, scene.mass_len, tile)
        r = _scene.measure(f"newton({tile})",
                           lambda tile=tile: newton_acc(
                               tgt, src, mass_len=scene.mass_len, tile=tile),
                           as_acc, want, scene, k1_ms, log)
        r["config"] = {"tile": tile, "forward_pairs": fwd, "dual_pairs": dual}
        log(f"  {'':>24}  {dual} dual pairs, {fwd} forward pairs")
        results.append(r)
    from ..ops.direct_forces import sm_count

    shapes = plan(scene.n, scene.mass_len, scene.s128,
                  sm_count(scene.pos.device.index or 0), log)
    loops = pair_loops(_build.library_path("newton_forces"), log)
    for r in results:
        r["plan"], r["sass"] = shapes[r["config"]["tile"]], loops[r["config"]["tile"]]
    return _scene.finish("K5h", results)


def check_direct(scene: _scene.Scene, log=print) -> list:
    """Every tile width against the plain direct sum of the scene (any N
    and mass_len), twice for bit-equality."""
    tgt, src = scene.tgt4(), scene.src4(scene.s128)
    want = scene.control()
    results = []
    for tile in SWEEP:
        first, again = (as_acc(newton_acc(tgt, src, mass_len=scene.mass_len,
                                          tile=tile)) for _ in range(2))
        same = torch.equal(first, again)
        err = _scene.rel(first, want)
        ok = same and err < _scene.BOUND and bool(torch.isfinite(first).all())
        log(f"  newton({tile}) at N={scene.n} mass_len={scene.mass_len} "
            f"({scene.mass_len % tile} ragged massive rows, {scene.n % tile} "
            f"ragged target rows) against the direct sum: max|d|/max|ref| "
            f"{err:.3e}, bit-equal {same}{'' if ok else '  FAIL'}")
        results.append({"name": f"newton({tile}) N={scene.n}", "err": err,
                        "ok": ok})
    return _scene.finish("K5h against the direct sum", results)


def jobs(n: int = _scene.N, reps: int | None = 20) -> list:
    """One "k5h" job of ``_side.py`` a tile width."""
    return [{"what": "k5h", "n": n, "tile": tile, "reps": reps} for tile in SWEEP]


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
    scene = _scene.make_scene()
    want = scene.control().cpu()
    rows = []
    for i, job in enumerate(work):
        tile = job["tile"]
        mw = scene.mass_len // tile * tile
        o, n = ([t[i]["ms"] for t in times[who]] for who in ("old", "new"))
        (old,), (new,) = (torch.load(OUT / "parent" / t / f"{j}.pt")
                          for t, j in (("0", i + 1), ("1", i)))
        row = {"tile": tile, "old": o, "new": n, "ratio": sum(n) / sum(o),
               "forward_rows_equal": _scene.bit_equal(old[:, mw:], new[:, mw:]),
               "massive_rel_old": _scene.rel(old[:, :mw].T, want[:mw]),
               "massive_rel_new": _scene.rel(new[:, :mw].T, want[:mw])}
        log(f"  K5h W={tile}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, "
            f"{n[1]:.4f} ms; new/old {row['ratio']:.4f}; rows from {mw} "
            f"{'bit-equal' if row['forward_rows_equal'] else 'DIFFERENT'}; "
            f"massive rows against the direct sum: old "
            f"{row['massive_rel_old']:.3e}, new {row['massive_rel_new']:.3e}")
        rows.append(row)
    old_lib = sorted((other / "build" / "kernels").glob("libnewton_forces-*.so"))
    if len(old_lib) != 1:
        raise RuntimeError(f"expected one newton_forces build in {other}, got {old_lib}")
    sass_old = pair_loops(old_lib[0], log, "old ")
    sass_new = pair_loops(_build.library_path("newton_forces"), log, "new ")
    same = sass_against(other, ("newton_forces",), log)
    return {"configs": rows, "sass_old": sass_old, "sass_new": sass_new,
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
    if argv and argv[0] == "plan":
        from ..ops.direct_forces import sm_count
        from .tune_direct import _card

        scene = _scene.make_scene()
        print(f"plan on {_card()}: N={scene.n} mass_len={scene.mass_len} "
              f"S128={scene.s128}")
        out = plan(scene.n, scene.mass_len, scene.s128,
                   sm_count(torch.cuda.current_device()))
        for w, ms in split(scene).items():
            out[w].update(ms)
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / "plan.json").write_text(json.dumps(out, indent=1))
        return
    n = int(argv[0]) if argv else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5h Newton", scene))
    check_direct(scene)


if __name__ == "__main__":
    main()
