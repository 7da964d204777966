"""Measurements behind the main-path pair loop's plan (``csrc/direct_tiles.cuh``
and ``ops/direct_forces.cluster_plan``), on the card:

    python -m nbody_tpu_torch.ablations.tune_direct sweep
    python -m nbody_tpu_torch.ablations.tune_direct launch
    python -m nbody_tpu_torch.ablations.tune_direct parent DIR

``sweep`` times the direct kernel's fused substep at N=65536 and N=1M (the
two-galaxy scene, seed 11037) and the ring hop kernel's D=4 hops on one
card over plans (P targets a thread, n_split blocks a target block), each
held against the plan (1, 1) of the same kernel: bit-equal where n_split =
1, within 5e-6 of max|a| otherwise; and force_acc at the P3M exact-core
rows' shape (T=64, S=524704) over its scratch splits, against its plain
version within 2e-5. It chose ``direct_forces.P_MAX``, ``LIVE_WARPS`` and
the rule of ``cluster_plan``.

``launch`` reads the host's side: µs to enqueue one launch by plan, and the
host-bound sharded N=65536 D=4 "cuda_ring" substep in profiler windows, in
turns, with each hop planned for its own shard's targets (``cluster_plan``)
and for the targets of all four shards at once: the hop kernel's union and
sum of device intervals and the ms on the clock, a substep.

``parent DIR`` holds this tree's kernels to another commit's, unpacked at
DIR (``git archive <commit> nbody_tpu_torch | tar -x -C DIR``). Each side
runs in a process of its own through its package's public wrappers
(``_side.py``), so no C signature is assumed, and the sides take turns
(old, new, new, old). Bits: the fused substep at N=1M and N=65536 and a
one-shard ring hop at N=65536, rsqrt and precise, this tree's at n_split =
1 (P = 1 and 2) against the other's as it plans. Times: the fused substep
at N=65536 and N=1M, and the hop kernel's profiler union in the sharded
N=65536 D=4 "cuda_ring" world, each side as it plans.

Each prints its lines and writes them as JSON to ``build/tune_direct/``.
Without a CUDA device each raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import direct_forces as df
from ..ops import ring_forces as rf
from . import _side
from ._scene import rel, require_cuda, time_it
from ._side import ring_window, world_state

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_direct"
SEED = 11037
BENCH_N = 65536
BIG_N = 1 << 20
BOUND = 5e-6                    # a split against the unsplit sum, max|a|
BOUND_BIG = 2e-5                # force_acc at S=524704 against its plain version


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


class Hops:
    """The D hops of a substep of each shard of an N-particle ring on one
    card, launched on one stream per shard at once, without the ring's
    copies: each shard's targets against every shard's real sources."""

    def __init__(self, n: int, d: int, device):
        import nbody_tpu_torch as nt
        from ..parallel import sharding as sh

        w = sh.ShardedWorld(nt.make_galaxies(n, 2, seed=SEED),
                            sh.make_mesh(devices=[device] * d))
        self.d, self.n, self.mass_len = d, n, w.mass_len
        self.pos, self.radius = w.pos, w.radius
        self.t_real = w.ring.t_real
        allpos = torch.cat(w.pos)
        self.src = [allpos[k * w.s_loc:k * w.s_loc + w.ring.n_real[k]]
                    for k in range(d)]
        self.gm = [w.ring.gm_src[k][:w.ring.n_real[k]] for k in range(d)]
        self.acc = [torch.zeros_like(p) for p in w.pos]
        self.streams = [torch.cuda.Stream(device) for _ in range(d)]

    def run(self, plan=None):
        """A function that launches every hop, ``plan`` or the wrapper's,
        hop h of shard k on k's stream after its hop h - 1."""
        def hop(k, j, accumulate):
            rf.ring_hop(self.pos[k], self.radius[k], self.src[j], self.gm[j],
                        self.acc[k], accumulate=accumulate,
                        t_real=self.t_real[k], plan=plan)

        def fn():
            main = torch.cuda.current_stream()
            for s in self.streams:
                s.wait_stream(main)
            for k, s in enumerate(self.streams):
                with torch.cuda.stream(s):
                    for h in range(self.d):
                        hop(k, (k - h) % self.d, h > 0)
            for s in self.streams:
                main.wait_stream(s)
        return fn

    def plan(self, j: int = 0) -> df.Plan:
        """The plan of shard 0's hop with shard j's sources."""
        return df.cluster_plan(self.pos[0].shape[0], self.gm[j].shape[0],
                               df.device_sms(self.pos[0].device),
                               t_real=self.t_real[0], max_split=df.MAX_CLUSTER)


def _write(name: str, rows: list) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"tune_direct_{name}.json").write_text(json.dumps(rows, indent=1))


def sweep(device, log=print) -> list:
    sms = df.device_sms(device)
    log(f"sweep on {_card()}, {sms} SMs")
    rows = []
    for n, reps, plans in (
            (BENCH_N, 20, [(p, k) for p in (1, 2) for k in range(1, 9)]),
            (BIG_N, 2, [(2, 1), (2, 2), (2, 3), (1, 1)])):
        pos, vel, radius, gm = world_state(n, device)
        pairs = n * gm.shape[0]
        default = df.cluster_plan(n, gm.shape[0], sms, max_split=df.MAX_CLUSTER)
        ref = df.fused_substep(1.0, pos, vel, radius, gm, plan=(1, 1))[2]
        for plan in map(df.Plan._make, plans):
            acc = df.fused_substep(1.0, pos, vel, radius, gm, plan=plan)[2]
            err = rel(acc, ref)
            same = bool(torch.equal(acc, ref))
            ms = time_it(lambda: df.fused_substep(1.0, pos, vel, radius, gm,
                                                  plan=plan), reps)
            ok = same if plan.n_split == 1 else err < BOUND
            rows.append({"what": f"fused N={n}", "plan": list(plan), "ms": ms,
                         "pairs_per_s": pairs / (ms * 1e-3), "rel": err,
                         "bit_equal_to_unsplit": same, "ok": ok,
                         "default": plan == default})
            log(f"  fused N={n} {plan.describe():45s} {ms:9.4f} ms "
                f"{pairs / (ms * 1e-3):.4e} pairs/s, vs (1, 1): {err:.3e} "
                f"bit-equal {same}{'  <- cluster_plan' if plan == default else ''}"
                f"{'' if ok else '  FAIL'}")
        if n == BIG_N:
            # force_acc's few targets: the P3M exact-core rows' shape
            tp, tr = pos[:64].contiguous(), radius[:64].contiguous()
            src = pos[:gm.shape[0]]
            default = df.cluster_plan(64, gm.shape[0], sms)
            want = df.force_acc_plain(tp, tr, src, gm)
            for plan in (df.Plan(1, k) for k in (8, 129, 257, 513, 1025)):
                err = rel(df.force_acc(tp, tr, src, gm, plan=plan), want)
                ms = time_it(lambda: df.force_acc(tp, tr, src, gm, plan=plan), 20)
                ok = err < BOUND_BIG
                rows.append({"what": f"force_acc T=64 S={gm.shape[0]}",
                             "plan": list(plan), "ms": ms, "rel_plain": err,
                             "ok": ok, "default": plan == default})
                log(f"  force_acc T=64 S={gm.shape[0]} {plan.describe():45s} "
                    f"{ms:9.4f} ms, vs plain: {err:.3e}"
                    f"{'  <- cluster_plan' if plan == default else ''}"
                    f"{'' if ok else '  FAIL'}")
        del pos, vel, radius, gm
    for n, reps, plans in ((BENCH_N, 20, [(2, k) for k in range(1, 6)]),
                           (BIG_N, 1, [(2, 1), (2, 2)])):
        hops = Hops(n, 4, device)
        pairs = n * hops.mass_len
        hops.run((1, 1))()
        ref = [a.clone() for a in hops.acc]
        for plan in map(df.Plan._make, plans):
            fn = hops.run(plan)
            fn()
            err = max(rel(a, b) for a, b in zip(hops.acc, ref))
            ms = time_it(fn, reps)
            ok = err < BOUND
            rows.append({"what": f"ring hops N={n} D=4", "plan": list(plan),
                         "ms": ms, "pairs_per_s": pairs / (ms * 1e-3),
                         "rel": err, "ok": ok,
                         "default": [list(hops.plan(j)) for j in range(4)]})
            log(f"  ring N={n} D=4 {plan.describe():45s} {ms:9.4f} ms a "
                f"substep's 16 hops at once, {pairs / (ms * 1e-3):.4e} "
                f"pairs/s, vs (1, 1): {err:.3e}{'' if ok else '  FAIL'}")
        log(f"  ring N={n} D=4 cluster_plan per visiting shard: "
            f"{[hops.plan(j).describe() for j in range(4)]}")
        del hops
    if not all(r["ok"] for r in rows):
        raise RuntimeError("a plan of the sweep is out of bound")
    return rows


def launch_cost(device, log=print, turns: int = 2) -> list:
    """Host µs to enqueue one fused_substep launch (T=1000, S=333: the
    device keeps up) by plan; and the sharded N=65536 D=4 "cuda_ring"
    substep's profiler windows with the hops planned for their own targets
    and for the four shards' targets at once, in turns (own, shared,
    shared, own) ``turns`` times."""
    log(f"launch on {_card()}")
    rows = []
    pos, vel, radius, gm = (x.to(device) for x in (
        torch.randn(1000, 2) * 100, torch.randn(1000, 2), torch.rand(1000) + 1,
        torch.rand(333) * 1e4))
    for plan in ((2, 1), (2, 2), (2, 8), (1, 1)):
        for _ in range(2):
            df.fused_substep(0.01, pos, vel, radius, gm, plan=plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            df.fused_substep(0.01, pos, vel, radius, gm, plan=plan)
        us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        rows.append({"what": "host us a fused_substep launch", "plan": plan,
                     "us": us})
        log(f"  host {us:.1f} µs a fused_substep launch, "
            f"{df.Plan(*plan).describe()}")

    def shared(t, s, sms, *, t_real=None, max_split=None):
        return df.cluster_plan(t, s, sms, t_real=BENCH_N, max_split=max_split)

    own = rf.cluster_plan
    try:
        for who in ("own", "shared", "shared", "own") * turns:
            rf.cluster_plan = own if who == "own" else shared
            df.PLANS.clear()
            rf.PLANS.clear()
            union, total, wall = ring_window(device, BENCH_N, 4)
            plans = sorted({p.describe() for p in rf.PLANS})
            rows.append({"what": f"sharded N={BENCH_N} D=4 cuda_ring",
                         "rule": who, "plans": plans, "union_ms": union,
                         "sum_ms": total, "wall_ms": wall})
            log(f"  sharded N={BENCH_N} D=4 cuda_ring, hops planned for "
                f"{who} targets {plans}: union {union:.4f} ms, sum "
                f"{total:.4f} ms, {wall:.4f} ms on the clock, a substep")
    finally:
        rf.cluster_plan = own
    return rows


def _fused(n: int, precise: bool = False, plan=None, reps=None, repeats=3):
    return {"what": "fused", "n": n, "precise": precise, "plan": plan,
            "reps": reps, "repeats": repeats}


def _hop(n: int, precise: bool = False, plan=None):
    return {"what": "hop", "n": n, "precise": precise, "plan": plan}


# (label, the other side's job, this tree's jobs at n_split = 1)
BIT_JOBS = [
    (f"fused N={BIG_N} {tag}", _fused(BIG_N, precise),
     [_fused(BIG_N, precise, (2, 1))])
    for precise, tag in ((False, "rsqrt"), (True, "precise"))
] + [
    (f"{what.__name__[1:]} N={BENCH_N} {tag}", what(BENCH_N, precise),
     [what(BENCH_N, precise, (p, 1)) for p in (1, 2)])
    for what in (_fused, _hop) for precise, tag in ((False, "rsqrt"),
                                                     (True, "precise"))
]
TIMED_JOBS = [_fused(BENCH_N, reps=20), _fused(BIG_N, reps=2, repeats=1),
              {"what": "ring", "n": BENCH_N, "d": 4}]
TIMED_LABELS = [f"fused N={BENCH_N} ms", f"fused N={BIG_N} ms",
                f"sharded N={BENCH_N} D=4 cuda_ring hop kernel union ms"]


def _side_run(root: Path, jobs: list, out: Path) -> list:
    """Run ``jobs`` in a process whose ``nbody_tpu_torch`` is ``root``'s;
    their times, outputs saved under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, _side.__file__, str(out / "jobs.json"), str(out)],
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, timeout=1800)
    if proc.returncode:
        raise RuntimeError(f"the side at {root} failed:\n{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"job"')]


def parent(other: Path, device, log=print) -> list:
    log(f"parent on {_card()}: this tree against {other}")
    old_bits = [job for _, job, _ in BIT_JOBS]
    new_bits = [job for _, _, jobs in BIT_JOBS for job in jobs]
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        root = other if who == "old" else ROOT
        jobs = (old_bits if who == "old" else new_bits) if turn < 2 else []
        res = _side_run(root, jobs + TIMED_JOBS, OUT / "parent" / f"{turn}")
        times[who].append(res[len(jobs):])
    rows, bad = [], []
    new_i = 0
    for i, (label, _, jobs) in enumerate(BIT_JOBS):
        want = torch.load(OUT / "parent" / "0" / f"{i}.pt")
        for job in jobs:
            got = torch.load(OUT / "parent" / "1" / f"{new_i}.pt")
            new_i += 1
            eq = all(torch.equal(a, b) for a, b in zip(got, want))
            tag = f"{label}, this tree at {df.Plan(*job['plan']).describe()}"
            log(f"  bits {tag}: {'equal' if eq else 'DIFFERENT'}")
            rows.append({"what": f"bits {tag}", "equal": eq})
            if not eq:
                bad.append(tag)
    for k, label in enumerate(TIMED_LABELS):
        key = "union_ms" if "union" in label else "ms"
        o, n = ([r[k][key] for r in times[who]] for who in ("old", "new"))
        ratio = sum(n) / sum(o)
        log(f"  {label}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, "
            f"{n[1]:.4f}; new/old {ratio:.4f}")
        rows.append({"what": label, "old": o, "new": n, "ratio": ratio})
    if bad:
        raise RuntimeError(f"bits differ from {other} at n_split = 1: {bad}")
    return rows


def run(mode: str, device, log=print, other: Path | None = None) -> list:
    """The rows of ``mode`` ("sweep", "launch" or "parent" against the
    commit unpacked at ``other``), written to OUT."""
    if mode == "parent":
        rows = parent(other, device, log)
    else:
        rows = {"sweep": sweep, "launch": launch_cost}[mode](device, log)
    _write(mode, rows)
    return rows


def main(argv: list[str] | None = None) -> None:
    device = require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if argv in (["sweep"], ["launch"]):
        run(argv[0], device)
    elif len(argv) == 2 and argv[0] == "parent":
        run("parent", device, other=Path(argv[1]).resolve())
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
