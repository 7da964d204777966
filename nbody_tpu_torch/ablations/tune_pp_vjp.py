"""K4's VJP (``csrc/p3m_pp_vjp.cu``) on the card: its range length R, and
this tree against another commit of the port.

    python -m nbody_tpu_torch.ablations.tune_pp_vjp rows
    python -m nbody_tpu_torch.ablations.tune_pp_vjp profile
    python -m nbody_tpu_torch.ablations.tune_pp_vjp parent DIR

``rows`` times ``p3m_pp.pp_cells_vjp`` (rsqrt, CUDA events, best of three)
at the N=1M slice (``SimConfig(pm_grid=2048, p3m_cell_capacity=768)``)
and at N=65536 (grid 512, cap 96), the two-galaxy scenes of seed 11037,
for each R of ``ROWS`` (``p3m_pp.VJP_RANGE`` set before the call), with
the scratch bytes, the tasks, and the longest task: the most source rows
one warp walks in one task, against K4's form (a warp a tile of 32
targets walking its cell's whole neighbourhood, the parent's VJP); at R =
``p3m_pp.VJP_RANGE`` also a profiler window's device ms of the pass, the
sums and the rest of the call, the host ms to enqueue a call and its
plan, and the ms a call with one task list (``VJP_HEAVY_TILES`` out of
reach) instead of the heavy cells' tasks first. Each
R's cotangents must stay within 2e-6 of max|ref| of those at R =
``p3m_pp.VJP_RANGE`` (R moves the order of each target's sums only).

``profile`` reads a torch.profiler window over the "p3m" rollout at the
slice, 2 steps forward and backward: the device's busy ms (the union of
its kernels' intervals), the wall ms and the idle share, and the device
ms of the kernels that take the most, K4's VJP among them.

``parent DIR`` holds this tree's K4 VJP to another commit's, unpacked at
DIR (``git archive <commit> nbody_tpu_torch | tar -x -C DIR``). Each side
runs in a process of its own through its package's public wrappers
(``_side.py``), and the sides take turns (old, new, new, old). Bits: both
row cotangents of every row at the slice and at N=65536, rsqrt and
precise (max|d| / max|old|: the two kernels sum in other orders). Times
(CUDA events, best of three; a profiler window's device busy time; the
peak MiB allocated above the inputs):
those calls and the "p3m" rollout's step, forward and backward, at the
slice (2 steps).

Each prints its lines and writes them as JSON to ``build/tune_pp_vjp/``.
Without a CUDA device each raises.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from ..ops import p3m_pp
from ._scene import require_cuda
from ._side import (best_ms, p3m_rollout_call, p3m_world, pp_vjp_call,
                    union_ms)
from .tune_direct import _card, _side_run

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_pp_vjp"
SLICE = (1 << 20, 2048, 768)      # (n, grid, cap)
DEFAULT = (65536, 512, 96)
ROWS = (128, 256, 512, 1024, 1536)
BOUND_ROWS = 2e-6
JOBS = [
    (f"K4 VJP N=1M slice {p}", {"what": "pp_vjp", "n": SLICE[0],
                                "grid": SLICE[1], "cap": SLICE[2],
                                "precise": p == "precise", "keep": True,
                                "reps": 5})
    for p in ("rsqrt", "precise")
] + [
    (f"K4 VJP N=65536 {p}", {"what": "pp_vjp", "n": DEFAULT[0],
                             "grid": DEFAULT[1], "cap": DEFAULT[2],
                             "precise": p == "precise", "keep": True,
                             "reps": 20})
    for p in ("rsqrt", "precise")
] + [
    ("'p3m' rollout N=1M slice, 2 steps forward and backward, a step",
     {"what": "p3m_rollout", "n": SLICE[0], "grid": SLICE[1],
      "cap": SLICE[2], "steps": 2, "repeats": 3}),
]


def task_rows(counts_t, counts_s, gc: int, cap_t: int, cap_s: int,
              rows: int) -> dict:
    """What one warp walks, from the counts: K4's form (a warp a tile of a
    cell, walking the cell's whole neighbourhood: its rows L) and this
    kernel's (a block of 4 warps a range of at most R rows of a cell's
    neighbourhood, each warp every 4th batch of 8 rows for every tile of
    the cell); the tasks of each; the warp iterations (a tile against a
    staged row) and the candidate pairs, the same in both."""
    live_t = counts_t.clamp(max=cap_t).long()
    hood = p3m_pp._neighbourhood(counts_s.clamp(max=cap_s).long(), gc)
    tiles = (live_t + p3m_pp.TILE - 1) // p3m_pp.TILE
    hood = torch.where(live_t > 0, hood, 0)
    span = hood.clamp(max=rows)
    walk = tiles * 8 * ((span + 31) // 32)   # 4 warps, batches of 8
    ranges = (hood + rows - 1) // rows
    return {"rows": rows, "longest_before": int(hood.max()),
            "longest_after": int(walk.max()),
            "tasks_before": int(tiles.sum()), "tasks_after": int(ranges.sum()),
            "warp_iterations": int((tiles * hood).sum()),
            "candidates": int((live_t * hood).sum())}


def device_split(fn) -> dict:
    """A torch.profiler window over one call of fn: device ms of the pass
    kernel (``vjp_kernel``), of the sums (``sum_kernel``) and of the rest
    (the plan's ops, the fills), the launches of those two kernels, and
    the call's wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = {"pass_ms": 0.0, "sums_ms": 0.0, "rest_ms": 0.0, "wall_ms": wall,
           "kernels": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("pass_ms" if "vjp_kernel" in e.name else
               "sums_ms" if "sum_kernel" in e.name else "rest_ms")
        out[key] += (e.time_range.end - e.time_range.start) / 1e3
        out["kernels"] += key != "rest_ms"
    return out


def host_ms(fn, calls: int = 50) -> float:
    """Host ms to enqueue one call of fn: the clock around ``calls`` calls
    that start on an idle card, without a sync between them (the card
    runs behind the host only if the host is the slower)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def rows_sweep(device, log=print) -> list:
    from ..ops import p3m_forces

    log(f"rows on {_card()}: K4 VJP a call over R")
    out = []
    fixed = p3m_pp.VJP_RANGE
    for spec, label in ((SLICE, "N=1M slice"), (DEFAULT, "N=65536")):
        world = p3m_world(*spec, device)
        fn = pp_vjp_call(world, False)
        st, s, cfg = world.state, world.mass_len, world.config
        bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], world.gm,
                                   grid=cfg.pm_grid,
                                   rc_cells=cfg.p3m_rc_cells, exact_targets=0)
        gc = cfg.pm_grid // cfg.p3m_rc_cells
        ref = [t.clone() for t in fn()]
        try:
            for rows in ROWS:
                p3m_pp.VJP_RANGE = rows
                got = fn()
                err = max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(got, ref))
                if not err < BOUND_ROWS:
                    raise SystemExit(f"tune_pp_vjp: R={rows} {label} moved "
                                     f"the cotangents by {err:.3e}")
                ms = best_ms(fn, 5 if spec is SLICE else 20, 3)
                plan = p3m_pp.vjp_plan(bins["counts_t"], bins["counts_s"], gc,
                                       spec[2], spec[2])
                t = task_rows(bins["counts_t"], bins["counts_s"], gc, spec[2],
                              spec[2], rows)
                mib = p3m_pp.vjp_scratch_bytes(st.pos.shape[0], s, plan) / 2**20
                row = {"what": label, "ms": ms, "scratch_mib": mib,
                       "rel_to_fixed": err, **t}
                log(f"  {label} R={rows}: {ms:.4f} ms, scratch {mib:.1f} MiB,"
                    f" {t['tasks_after']} tasks (K4's form "
                    f"{t['tasks_before']}), longest task {t['longest_after']}"
                    f" rows a warp (K4's form {t['longest_before']}); "
                    f"max|d|/max|R={fixed}| {err:.2e}")
                if rows == fixed:
                    row.update(device_split(fn))
                    row["host_ms"] = host_ms(fn)
                    row["plan_host_ms"] = host_ms(lambda: p3m_pp.vjp_plan(
                        bins["counts_t"], bins["counts_s"], gc, spec[2],
                        spec[2]))
                    heavy = p3m_pp.VJP_HEAVY_TILES
                    p3m_pp.VJP_HEAVY_TILES = 1 << 30
                    try:
                        row["one_list_ms"] = best_ms(
                            fn, 5 if spec is SLICE else 20, 3)
                    finally:
                        p3m_pp.VJP_HEAVY_TILES = heavy
                    log(f"    R={rows}: device ms of one call: pass "
                        f"{row['pass_ms']:.4f}, sums {row['sums_ms']:.4f}, "
                        f"the rest {row['rest_ms']:.4f}; host ms to enqueue "
                        f"a call {row['host_ms']:.4f}, of which the plan "
                        f"{row['plan_host_ms']:.4f}; without the heavy "
                        f"cells first {row['one_list_ms']:.4f} ms a call")
                out.append(row)
        finally:
            p3m_pp.VJP_RANGE = fixed
        del world, fn, ref
    return out


def rollout_profile(device, log=print, top: int = 12) -> dict:
    """The profiler window of ``profile`` (see the module's doc)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log(f"profile on {_card()}: the 'p3m' rollout at the N=1M slice, 2 "
        f"steps forward and backward")
    fn = p3m_rollout_call(p3m_world(*SLICE, device), 2)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        # the ranges of record_function (p3m.*) span their kernels and the
        # gaps between them: not device work of their own
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    busy = union_ms(spans)
    log(f"  busy {busy:.4f} ms of {wall:.4f} ms wall under the profiler "
        f"(idle {1 - busy / wall:.1%}), {len(spans)} device intervals")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in ranked[:top]:
        log(f"    {ms:9.4f} ms  {name[:110]}")
    return {"busy_ms": busy, "wall_ms": wall,
            "kernels": [{"name": n, "ms": ms} for n, ms in ranked[:top]]}


def parent(other: Path, log=print) -> list:
    log(f"parent on {_card()}: this tree against {other}")
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        jobs = [dict(job) for _, job in JOBS]
        for job in jobs:
            job["keep"] = job.get("keep", False) and turn < 2
        res = _side_run(other if who == "old" else ROOT, jobs,
                        OUT / "parent" / f"{turn}")
        times[who].append(res)
    rows = []
    for i, (label, job) in enumerate(JOBS):
        o, n = ([r[i]["ms"] for r in times[who]] for who in ("old", "new"))
        do, dn = ([r[i]["device_ms"] for r in times[who]]
                  for who in ("old", "new"))
        po, pn = ([r[i]["peak_mib"] for r in times[who]]
                  for who in ("old", "new"))
        row = {"what": label, "old": o, "new": n, "ratio": sum(n) / sum(o),
               "old_device": do, "new_device": dn, "old_peak_mib": po,
               "new_peak_mib": pn}
        line = (f"  {label}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, "
                f"{n[1]:.4f} ms; new/old {row['ratio']:.4f}; device old "
                f"{do[0]:.4f}, {do[1]:.4f}, new {dn[0]:.4f}, {dn[1]:.4f}; "
                f"peak MiB old {po[0]:.1f}, new {pn[0]:.1f}")
        path = [OUT / "parent" / t / f"{i}.pt" for t in ("0", "1")]
        if path[0].exists():
            old, new = (torch.load(q) for q in path)
            row["rel"] = [float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(new, old)]
            line += "; max|d|/max|old| d_trows {:.2e}, d_srows {:.2e}".format(
                *row["rel"])
        log(line)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> None:
    device = require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["rows"]:
        rows, name = rows_sweep(device), "rows.json"
    elif argv == ["profile"]:
        rows, name = rollout_profile(device), "profile.json"
    elif len(argv) == 2 and argv[0] == "parent":
        rows, name = parent(Path(argv[1]).resolve()), "parent.json"
    else:
        raise SystemExit(__doc__)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / name).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
