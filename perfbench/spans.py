"""The spans window: some of the traffic's calls with the program's own
tracer on (``nbody_tpu_torch.utils.profiling``) and no profiler, read
into the host-side per-layer metrics.

The first reader that asks for it runs the window, after the judge, in a
process of its own (``python3 -m perfbench.spans window``, the request
on standard input, the spans as JSON on standard output), so that no
profiler has run in it: a world of the cell from the run's seed, the
warm-up call, then ``SPAN_CALLS`` calls of the traffic from the set-up's
initial state, one sync, and ``profiling.collect()``, kept as
``ctx.spans``. Where the program has no tracer ``ctx.spans`` is None and
every reader of it reports nothing. The window logs on standard error
its host time a substep against the measured window's, and its stall
report: the longest ``world.update`` call and the longest ``substep``,
each with the stage that held most of it, against the medians.

"Inside" a set of spans means inside their union, so a nested span is
counted once.

``python3 -m perfbench.spans cost --workload <cell> --seed <n> --rounds
<r>`` measures the tracer's cost: windows of ``SPAN_CALLS`` calls with
the tracer off and on in turns, in one world, each its ms a substep.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPAN_CALLS = 10
WINDOW_TIMEOUT_S = 900
UPDATE, SUBSTEP = "world.update", "substep"
# the program's profiling.Span, field for field
Span = namedtuple("Span", "name parent start_ns end_ns step")


def tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from nbody_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "enable") else None


def build(cell, seed: int, device):
    """A world of ``cell`` and its driver from ``seed``, warmed up:
    (driver, sync)."""
    import torch

    import nbody_tpu_torch as nbt

    from . import scene

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    cfg = cell.config
    sc = scene.deployment(cfg["scene"], seed)
    world = cell.world().build(nbt, cfg, sc, device)
    drv = cell.driver().Driver(world, cfg, cell.traffic, sync)
    drv.warm()
    sync()
    return drv, sync


def calls(drv, sync, n: int) -> float:
    """``n`` calls of the traffic and one sync: seconds on the host clock."""
    t0 = time.perf_counter()
    for _ in range(n):
        drv.call()
    sync()
    return time.perf_counter() - t0


def window(ctx):
    """The spans window's ``collect()``, with ``wall_s`` and ``substeps``
    added, from a process of its own; None where the program has no
    tracer. Raises where that process fails."""
    if tracer() is None:
        ctx.log("spans window: the program has no tracer")
        return None
    request = {"workload": ctx.cell.name, "config": ctx.config,
               "traffic": ctx.cell.traffic, "seed": ctx.seed,
               "device": str(ctx.gm.device), "calls": SPAN_CALLS}
    done = subprocess.run(
        [sys.executable, "-m", "perfbench.spans", "window"],
        input=json.dumps(request), capture_output=True, text=True, cwd=ROOT,
        timeout=WINDOW_TIMEOUT_S)
    if done.returncode != 0:
        raise RuntimeError(f"spans window failed ({done.returncode}):\n"
                           f"{done.stderr[-4000:]}")
    rec = json.loads(done.stdout.splitlines()[-1])
    rec["spans"] = [Span(*s) for s in rec["spans"]]
    report(rec, ctx)
    return rec


def run_window(request: dict) -> dict:
    """The spans window in this process, as ``window`` asks for it."""
    import torch

    from . import harness

    profiling = tracer()
    cell = harness.load_cell(request["workload"])
    cell.config, cell.traffic = request["config"], request["traffic"]
    drv, sync = build(cell, request["seed"], torch.device(request["device"]))
    profiling.collect()
    profiling.enable()
    try:
        wall_s = calls(drv, sync, request["calls"])
    finally:
        profiling.disable()
    rec = profiling.collect()
    return {"spans": [list(s) for s in rec["spans"]], "counts": rec["counts"],
            "anchor": list(rec["anchor"]), "wall_s": wall_s,
            "substeps": request["calls"] * drv.per_call}


def of(ctx):
    """``ctx.spans``, running the spans window the first time."""
    if not hasattr(ctx, "spans"):
        ctx.spans = window(ctx)
    return ctx.spans


# --- arithmetic on spans: intervals in ns of time.perf_counter_ns ---

def union(intervals) -> list:
    """Sorted disjoint [start, end] covering ``intervals``."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(merged) -> int:
    return sum(b - a for a, b in merged)


def overlap(x, y) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def intervals(spans, names) -> list:
    return union((s.start_ns, s.end_ns) for s in spans if s.name in names)


def substeps(rec) -> int:
    return sum(s.name == SUBSTEP for s in rec["spans"])


def per_substep_ms(rec, ns: int):
    n = substeps(rec)
    return ns / n / 1e6 if n else None


def host_ms(ctx, names):
    """Host ms a substep inside the spans ``names``; None where the
    window has none of them."""
    rec = of(ctx)
    if rec is None:
        return None
    iv = intervals(rec["spans"], set(names))
    return per_substep_ms(rec, length(iv)) if iv else None


def loop_self_ns(spans) -> int:
    """Time inside ``world.update`` covered by no span other than
    ``substep``: the integrator and the Python around the stages."""
    updates = intervals(spans, {UPDATE})
    inner = union((s.start_ns, s.end_ns) for s in spans
                  if s.name not in (UPDATE, SUBSTEP))
    return length(updates) - overlap(updates, inner)


def counted_pct(ctx, part: str, whole: str):
    """100 × counter ``part`` / counter ``whole`` over the spans window."""
    rec = of(ctx)
    if rec is None or not rec["counts"].get(whole):
        return None
    return 100.0 * rec["counts"].get(part, 0) / rec["counts"][whole]


# --- the stall report ---

def held(spans, children, i: int) -> dict:
    """{stage: ns} of span ``i``: its children, the children of a
    ``substep`` in its place, and "self" for the rest."""
    kids, todo = [], list(children.get(i, ()))
    while todo:
        k = todo.pop()
        if spans[k].name == SUBSTEP:
            todo.extend(children.get(k, ()))
        else:
            kids.append(k)
    out: dict = {}
    for k in kids:
        name, ns = spans[k].name, spans[k].end_ns - spans[k].start_ns
        out[name] = out.get(name, 0) + ns
    s = spans[i]
    out["self"] = s.end_ns - s.start_ns - length(
        union((spans[k].start_ns, spans[k].end_ns) for k in kids))
    return out


def stalls(rec) -> list:
    """For ``world.update`` and ``substep``: (name, count, median ms,
    longest ms, its step, the stage that held most of it, that stage's ms
    in it, that stage's median ms in the others)."""
    spans = rec["spans"]
    children: dict = {}
    for k, s in enumerate(spans):
        children.setdefault(s.parent, []).append(k)
    out = []
    for name in (UPDATE, SUBSTEP):
        idx = [k for k, s in enumerate(spans) if s.name == name]
        if not idx:
            continue
        dur = {k: spans[k].end_ns - spans[k].start_ns for k in idx}
        worst = max(idx, key=dur.get)
        parts = held(spans, children, worst)
        stage = max(parts, key=parts.get)
        usual = statistics.median(held(spans, children, k).get(stage, 0)
                                  for k in idx)
        out.append((name, len(idx), statistics.median(dur.values()) / 1e6,
                    dur[worst] / 1e6, spans[worst].step, stage,
                    parts[stage] / 1e6, usual / 1e6))
    return out


def report(rec, ctx) -> None:
    """The spans window's host times and stall report, on standard error."""
    spans, n = rec["spans"], rec["substeps"]
    measured = ctx.run_s / ctx.substeps * 1e3 if ctx.substeps else float("nan")
    ctx.log(f"spans window: {SPAN_CALLS} calls, {n} substeps, {len(spans)} "
            f"spans, {rec['wall_s'] / n * 1e3!r} ms a substep with the "
            f"tracer on (measured window, tracer off: {measured!r})")
    update = per_substep_ms(rec, length(intervals(spans, {UPDATE})))
    own = per_substep_ms(rec, loop_self_ns(spans))
    names = sorted({s.name for s in spans} - {UPDATE, SUBSTEP})
    stages = ", ".join(
        f"{k} {per_substep_ms(rec, length(intervals(spans, {k})))!r}"
        for k in names)
    ctx.log(f"spans window, host ms a substep: inside {UPDATE} {update!r}; "
            f"outside every stage {own!r}; "
            f"{stages}")
    ctx.log(f"spans window counters: {rec['counts']}")
    for name, k, med, worst, step, stage, ms, usual in stalls(rec):
        ctx.log(f"stall report: longest {name} of {k} {worst!r} ms (median "
                f"{med!r}), substep {step}; most of it in {stage} {ms!r} ms "
                f"(median {usual!r})")


def cost(profiling, args) -> None:
    """The tracer's cost: windows of SPAN_CALLS calls, off and on in turns
    (off first in even rounds, on first in odd ones)."""
    import torch

    from . import harness

    drv, sync = build(harness.load_cell(args.workload), args.seed,
                      torch.device("cuda"))
    n = SPAN_CALLS * drv.per_call
    print(f"{args.workload} seed {args.seed}, {harness.power_limit()}")
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            if on:
                profiling.enable()
            try:
                s = calls(drv, sync, SPAN_CALLS)
            finally:
                profiling.disable()
            spans = len(profiling.collect()["spans"])
            print(f"round {r} tracer {'on ' if on else 'off'}: "
                  f"{s / n * 1e3!r} ms a substep, {spans} spans", flush=True)


def main(argv=None) -> int:
    """``window``: the spans window of the JSON request on standard input;
    ``cost``: the tracer's cost on the card."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("what", choices=("window", "cost"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.setdefault("NBODY_TPU_TORCH_CACHE_DIR",
                          str(ROOT / "build" / "kernels"))

    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profiling = tracer()
    if profiling is None:
        print("perfbench.spans: the program has no tracer", file=sys.stderr)
        return 2
    if args.what == "window":
        print(json.dumps(run_window(json.loads(sys.stdin.read()))))
    elif not torch.cuda.is_available():
        print("perfbench.spans: cost needs a CUDA card", file=sys.stderr)
        return 2
    else:
        cost(profiling, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
