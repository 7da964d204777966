"""One side of ``tune_direct parent``, ``tune_p3m parent`` (and of
``tune_merge_vjp``, ``tune_pp_vjp`` and ``tune_r2b``'s): the kernels
of whichever ``nbody_tpu_torch`` comes first on ``sys.path``, driven
through its public wrappers alone (``create_world``,
``direct_forces.fused_substep``, ``ring_forces.ring_hop``, a "cuda_ring"
``ShardedWorld``, ``p3m_forces.p3m_bins`` and ``p3m_pp``'s ``pp_cells``
where the tree has it, else ``pp_blocks``), so that it runs against any
commit of the port that has the ring. A job passes ``plan`` only where it
gives one.

    PYTHONPATH=ROOT python nbody_tpu_torch/ablations/_side.py JOBS.json OUT_DIR

JOBS.json is a list of jobs, each {"what": "fused" | "hop" | "ring" |
"pp" | "p3m" | "contacts" | "vjp" | "merging" | "rollout" | "pp_vjp" |
"p3m_rollout" | "v2" | "k5a" | "k5i" | "k5d" | "k5c" | "k5h" | "k5g" |
"k5e" | "build", "n", ...} (the four after "p3m" are tune_merge_vjp's, the
next two tune_pp_vjp's, "v2" tune_r2b's, "k5a" and "build" tune_r2's,
"k5i" tune_r4d_bcast_probe's, "k5d" tune_r2d's, "k5c" tune_r2c's, "k5h"
tune_r2h's, "k5g" tune_r2g's, "k5e" tune_r2e's, below):
"fused" is one fused
substep of the N-particle two-galaxy world (seed 11037); "hop" that
world's state as the only hop of a one-shard ring, with its epilogue;
"ring" a profiler window over a "cuda_ring" ShardedWorld of ``d`` shards
on the card; "pp" the P3M pair
correction (K4) of that world's initial state with ``grid`` and ``cap``,
the call that world.update(backend="p3m") makes (its output one (x, y) a
target in cell order, 0 past a cell's cap); "p3m" ``substeps`` p3m
substeps of that world. "contacts" is the merge pass's contact search
(``collisions.contacts``, factor 1) on that world's massive prefix after
``substeps`` unmerged substeps of 0.01 (its output the winners); "vjp" is
``direct_forces.force_acc_vjp`` on that world's state (all rows against
the prefix, or with "core" the P3M exact-core rows of the slice config
against it) with a cotangent from seed 1 (its output the four
cotangents); "merging" is ``substeps`` merging substeps of 0.01 of that
world, timed from the state after 10; "rollout" is the "cuda" rollout's
forward and backward, precise, ``steps`` steps of 0.01, the loss on the
first tracer. "pp_vjp" is ``p3m_pp.pp_cells_vjp`` on the rows and runs
that the p3m world of ``grid`` and ``cap`` hands K4 at its initial state,
with a cotangent from seed 3 (its outputs the two row cotangents);
"p3m_rollout" that world's "p3m" rollout, ``steps`` steps of 0.01 forward
and backward, the loss sum(pos²); both also give the device ms of one
call (a profiler window's busy time) and the peak MiB allocated above
their inputs. "v2" is one K5b configuration (``flavor``, ``rows``,
``tile_t``, ``chunk``) on that world's scene (``ablations._scene``):
``v2_forces.v2_acc`` where the tree has it, else
``flavor_forces.flavor_acc`` with the same flavor, layout, tile and chunk,
each at its own module's ``shape(tile_t)`` (its output the (N, 2) force,
its times also its P). "k5a" is ``resident_forces.v2_acc`` on that scene
at ``block`` (targets a block), ``chunk`` and ``precise``, and at
``n_split`` where the job gives one (its output the (N, 2) force). "k5i"
is ``bcast_probe.bcast_acc`` at the probe's shape on its inputs
(``abs_row2``: the third target row made positive) by ``variant``, at
``n_split`` ranges (absent: the tree's own plan, its times also that
plan; its output the (2, T) result). "k5d" is
``stationary_forces.stationary_acc`` on that scene's (3, N) targets and
its sources padded to a whole number of chunks, at ``block`` (targets a
tile), ``chunk``, ``slabs`` (None: the tree's slab plan, its times also
the slabs) and ``precise`` (its output the (2, N) force). "k5c" is the
probe ``flavor`` on that scene's rows, chunk 2048: ``v2_forces.v2_acc``
at ``p`` and a tile of 512 where the tree's ``v2_forces`` has K5c's
flavors, else ``flavor_forces.flavor_acc`` at P = 1 in blocks of 512 (its
output the (N, 2) force, its times also its P). "k5h" is
``newton_forces.newton_acc`` on that scene's (4, N) targets and its S128
sources at ``tile`` (its output the (2, N) force). "k5g" is
``ptile_forces.ptile_acc`` on that scene's (3, N) targets and its S128
sources at ``p``, ``block`` and ``chunk``, and at ``n_split`` where the job
gives one (its times also the split: the job's or the tree's
``split_plan``); "k5e" is ``flavor_forces.flavor_acc`` there by ``flavor``
at the script's ``tile_t`` (``flavor_forces.shape``) and ``chunk`` (its
times also P and the split plan); the output of both the (2, N) force.
"build" builds the kernels
``names`` and runs nothing. A job's outputs go to OUT_DIR/<index>.pt, and one
JSON line a job gives its times (ms; "reps" calls between CUDA events, the
best of "repeats"; a "p3m" job's ms are a substep's).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

SEED = 11037


def world_state(n: int, device) -> tuple:
    """(pos, vel, radius, gm) of the two-galaxy world of n particles."""
    import nbody_tpu_torch as nt

    w = nt.create_world(nt.make_galaxies(n, 2, seed=SEED), device=device)
    st = w.state
    return st.pos, st.vel, st.radius, w.gm


def best_ms(fn, reps: int, repeats: int) -> float:
    """Milliseconds a call of fn: one warm-up call, then the best of
    ``repeats`` runs of ``reps`` calls between CUDA events."""
    fn()
    best = float("inf")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(repeats):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_ms(fn) -> float:
    """Device ms of one call of fn: the union of its device intervals in a
    torch.profiler window (the ranges of record_function left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return union_ms([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)])


def union_ms(spans) -> float:
    """ms covered by the union of (start, end) intervals in µs."""
    spans = sorted(spans)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def ring_window(device, n: int, d: int, substeps: int = 5) -> tuple:
    """(union, sum of the hop kernel's device intervals, wall ms) a substep
    of a torch.profiler window over a "cuda_ring" ShardedWorld of n
    particles in d shards on one card."""
    import nbody_tpu_torch as nt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.parallel import sharding as sh

    w = sh.ShardedWorld(nt.make_galaxies(n, 2, seed=SEED),
                        sh.make_mesh(devices=[device] * d),
                        force_backend="cuda_ring")
    w.update(1.0, 2)
    w.block_until_ready()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w.update(1.0, substeps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / substeps
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "ring_hop_kernel" in e.name]
    return (union_ms(spans) / substeps,
            sum(b - a for a, b in spans) / 1e3 / substeps, wall)


def p3m_world(n: int, grid: int, cap: int, device):
    import nbody_tpu_torch as nt

    return nt.create_world(nt.make_galaxies(n, 2, seed=SEED), device=device,
                           config=nt.SimConfig(pm_grid=grid,
                                               p3m_cell_capacity=cap))


def pp_call(world, precise: bool):
    """(fn, to_rows): the K4 call that a p3m substep makes on the world's
    state, and the map from its output to one (x, y) a target in cell
    order. Through ``pp_cells`` where this tree has it; else through
    ``pp_blocks`` with the counts, on blocks packed here."""
    from nbody_tpu_torch.ops import p3m_forces, p3m_pp

    cfg, st, s = world.config, world.state, world.mass_len
    gc, cap = cfg.pm_grid // cfg.p3m_rc_cells, cfg.p3m_cell_capacity
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], world.gm,
                               grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                               exact_targets=0)
    rc = cfg.p3m_rc_cells * bins["h"]
    sides = ((st.pos, st.radius, bins["order_t"], bins["counts_t"]),
             (st.pos[:s], world.gm, bins["order_s"], bins["counts_s"]))
    if hasattr(p3m_pp, "pp_cells"):
        floor = p3m_pp.SOFTENING_FLOOR
        rows = [torch.cat([xy, w[:, None] + f, torch.zeros_like(w)[:, None]],
                          1)[order]
                for (xy, w, order, _), f in zip(sides, (floor, 0.0))]
        runs = [bins[k] for k in ("start_t", "counts_t", "start_s",
                                  "counts_s")]

        def fn():
            return p3m_pp.pp_cells(*rows, *runs, rc, 4.0, cap_t=cap,
                                   cap_s=cap, precise=precise)
        return fn, lambda out: out
    blocks, slots = [], None
    for (xy, w, order, counts), fills in zip(sides, ((0.0, 0.0, 1.0),
                                                      (0.0, 0.0, 0.0))):
        cols = torch.cat([xy, w[:, None]], 1)[order]
        cid = torch.repeat_interleave(
            torch.arange(gc * gc, device=xy.device), counts.long())
        rank = torch.arange(len(cid), device=cid.device) \
            - (torch.cumsum(counts.long(), 0) - counts.long())[cid]
        slot = torch.where(rank < cap, cid * cap + rank, gc * gc * cap)
        slots = slot if slots is None else slots
        for k, f in enumerate(fills):
            b = torch.full((gc * gc * cap + 1,), f, device=cid.device)
            b[slot] = cols[:, k]
            blocks.append(b[:-1].reshape(gc, gc, cap))

    def fn():
        return p3m_pp.pp_blocks(*blocks, rc, 4.0, precise=precise,
                                counts_t=bins["counts_t"],
                                counts_s=bins["counts_s"])

    def to_rows(out):
        flat = torch.cat([out.reshape(-1, 2), torch.zeros_like(out[0, :1])])
        return flat[slots]
    return fn, to_rows


def pp_vjp_call(world, precise: bool):
    """The K4 VJP call that the backward of a "p3m" rollout step makes on
    the world's state (rows and runs as ``pp_call``'s), with a cotangent
    from seed 3."""
    import numpy as np

    from nbody_tpu_torch.ops import p3m_forces, p3m_pp

    cfg, st, s = world.config, world.state, world.mass_len
    cap = cfg.p3m_cell_capacity
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], world.gm,
                               grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                               exact_targets=0)
    rc = cfg.p3m_rc_cells * bins["h"]
    rows = [torch.cat([xy, w[:, None] + f, torch.zeros_like(w)[:, None]],
                      1)[order]
            for xy, w, order, f in (
                (st.pos, st.radius, bins["order_t"], p3m_pp.SOFTENING_FLOOR),
                (st.pos[:s], world.gm, bins["order_s"], 0.0))]
    runs = [bins[k] for k in ("start_t", "counts_t", "start_s", "counts_s")]
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(rows[0].shape[0], 2)).astype(np.float32)).to(st.pos.device)

    def fn():
        return p3m_pp.pp_cells_vjp(*rows, *runs, rc, 4.0, g, cap_t=cap,
                                   cap_s=cap, precise=precise)
    return fn


def p3m_rollout_call(world, steps: int):
    """The "p3m" rollout of the world's config from its state, forward and
    backward: d sum(pos²) / d pos0 after ``steps`` steps of 0.01."""
    from nbody_tpu_torch import autodiff

    cfg, st = world.config, world.state
    kw = dict(n_steps=steps, mass_len=world.mass_len, backend="p3m",
              precise=cfg.precise, g=cfg.g, pm_grid=cfg.pm_grid,
              pm_softening=cfg.pm_softening, p3m_rc_cells=cfg.p3m_rc_cells,
              p3m_cell_capacity=cfg.p3m_cell_capacity,
              p3m_exact_targets=cfg.p3m_exact_targets,
              p3m_rebin_interval=cfg.p3m_rebin_interval,
              integrator=cfg.integrator)
    dt = torch.full((), 0.01, device=st.pos.device)

    def fn():
        p = st.pos.detach().clone().requires_grad_()
        fin, _ = autodiff.rollout(p, st.vel, st.mass, st.radius, dt, **kw)
        return torch.autograd.grad(torch.sum(fin ** 2), p)[0]
    return fn


def p3m_substep_ms(world, substeps: int, repeats: int) -> float:
    """Device ms a p3m substep: the best of ``repeats`` runs of
    ``substeps`` substeps between CUDA events, after one warm-up."""
    return best_ms(lambda: world.update(1.0, substeps, backend="p3m"), 1,
                   repeats) / substeps


def backward_job(job: dict, device) -> tuple:
    """(times, outputs) of a "contacts", "vjp", "merging" or "rollout"
    job."""
    import numpy as np

    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import collisions as col
    from nbody_tpu_torch.ops import direct_forces as df

    n, what = job["n"], job["what"]
    scene = nt.make_galaxies(n, 2, seed=SEED)
    reps, repeats = job.get("reps", 10), job.get("repeats", 3)
    if what == "merging":
        w = nt.create_world(scene, device=device,
                            config=nt.SimConfig(merge_collisions=True))
        w.update(0.01, 10)
        k = job["substeps"]
        return {"ms": best_ms(lambda: w.update(0.01, k), 1, repeats) / k}, None
    if what == "rollout":
        from nbody_tpu_torch import autodiff

        w = nt.create_world(scene, device=device,
                            config=nt.SimConfig(precise=True))
        st, ml = w.state, w.mass_len
        loss = autodiff.trajectory_loss(st.pos[ml] + 5.0, ml)
        dt = torch.full((), 0.01, device=device)

        def fn():
            xs = [x.detach().clone().requires_grad_()
                  for x in (st.pos, st.vel)]
            val = loss(*xs, st.mass, st.radius, dt, n_steps=job["steps"],
                       mass_len=ml, backend="cuda", precise=True)
            return torch.autograd.grad(val, xs)
        return {"ms": best_ms(fn, 1, repeats) / job["steps"]}, None
    if what == "contacts":
        w = nt.create_world(scene, device=device)
        if job.get("substeps"):
            w.update(0.01, job["substeps"])
        m, st = w.mass_len, w.state
        args = (st.pos[:m].contiguous(), st.radius[:m].contiguous(),
                st.mass[:m].contiguous(), w.gm > 0, 1.0)
        out = [t.cpu() for t in col.contacts(*args)]
        return {"ms": best_ms(lambda: col.contacts(*args), reps,
                              repeats)}, out
    cfg = nt.SimConfig(pm_grid=2048, p3m_cell_capacity=768)
    w = nt.create_world(scene, device=device, config=cfg)
    st, m = w.state, w.mass_len
    tp, tr = st.pos, st.radius
    if job.get("core"):
        from nbody_tpu_torch.ops import p3m_forces

        rows = p3m_forces.exact_core_rows(st.radius, cfg.p3m_exact_targets)
        tp, tr = tp[rows].contiguous(), tr[rows].contiguous()
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(tp.shape[0], 2)).astype(np.float32)).to(device)
    args = (tp, tr, st.pos[:m], w.gm, g)
    kw = {"precise": job.get("precise", False)}
    out = [t.cpu() for t in df.force_acc_vjp(*args, **kw)]
    return {"ms": best_ms(lambda: df.force_acc_vjp(*args, **kw), reps,
                          repeats)}, out


def v2_job(job: dict, device, worlds: dict) -> tuple:
    """(times, [the (N, 2) force]) of a "v2" job."""
    import importlib.util

    from nbody_tpu_torch.ablations import _scene
    from nbody_tpu_torch.ops import flavor_forces as ff

    key = ("scene", job["n"])
    if key not in worlds:
        worlds.clear()
        worlds[key] = _scene.make_scene(job["n"], device=device)
    sc = worlds[key]
    src = sc.src3(sc.s128)
    tgt = sc.tgt3() if job["rows"] else (sc.pos, sc.radius)
    if importlib.util.find_spec("nbody_tpu_torch.ops.v2_forces") is None:
        mod, acc = ff, ff.flavor_acc
    else:
        from nbody_tpu_torch.ops import v2_forces as mod
        acc = mod.v2_acc
    p, block = mod.shape(job["tile_t"])

    def fn():
        return acc(tgt, src, flavor=job["flavor"], p=p, block=block,
                   chunk=job["chunk"])
    out = [ff.as_acc(fn()).cpu()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms, "p": p}, out


def k5_job(job: dict, device, worlds: dict) -> tuple:
    """(times, [output]) of a "k5a" or "k5i" job."""
    from nbody_tpu_torch.ablations import _scene

    if job["what"] == "k5a":
        from nbody_tpu_torch.ops import resident_forces as rsf

        key = ("scene", job["n"])
        if key not in worlds:
            worlds.clear()
            worlds[key] = _scene.make_scene(job["n"], device=device)
        sc = worlds[key]
        src = sc.src3(sc.s128)
        kw = {"n_split": job["n_split"]} if job.get("n_split") else {}

        def fn():
            return rsf.v2_acc(sc.pos, sc.radius, src, block=job["block"],
                              chunk=job["chunk"], precise=job["precise"], **kw)
        times = {}
    else:
        from nbody_tpu_torch.ablations import tune_r4d_bcast_probe as k5i
        from nbody_tpu_torch.ops import bcast_probe as bp
        from nbody_tpu_torch.ops.direct_forces import sm_count

        tgt, src = k5i.inputs(device, job["abs_row2"])
        plan = (bp.split_plan(k5i.T, k5i.REPS, sm_count(device.index or 0))
                if device.type == "cuda" else 1)
        n_split = job.get("n_split") or plan

        def fn():
            return bp.bcast_acc(tgt, src, variant=job["variant"],
                                reps=k5i.REPS, n_split=n_split)
        times = {"plan": plan, "n_split": n_split}
    out = [fn().cpu()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms, **times}, out


def stationary_probe_job(job: dict, device, worlds: dict) -> tuple:
    """(times, [output]) of a "k5d" or "k5c" job."""
    from nbody_tpu_torch.ablations import _scene

    key = ("scene", job["n"])
    if key not in worlds:
        worlds.clear()
        worlds[key] = _scene.make_scene(job["n"], device=device)
    sc = worlds[key]
    tgt = sc.tgt3()
    if job["what"] == "k5d":
        from nbody_tpu_torch.ops import stationary_forces as stf
        from nbody_tpu_torch.ops.direct_forces import sm_count

        chunk = job["chunk"]
        src = sc.src3(-(-sc.mass_len // chunk) * chunk)
        slabs = job.get("slabs")
        if slabs is None and device.type == "cuda":
            slabs = stf.slab_plan(sc.n, src.shape[-1], job["block"], chunk,
                                  sm_count(device.index or 0))

        def fn():
            return stf.stationary_acc(tgt, src, block=job["block"],
                                      chunk=chunk, slabs=slabs,
                                      precise=job["precise"])
        times = {"slabs": slabs}
    else:
        from nbody_tpu_torch.ops import flavor_forces as ff
        from nbody_tpu_torch.ops import v2_forces as v2

        src = sc.src3(sc.s128)
        if "skeleton" in v2.FLAVORS:
            p = job["p"]

            def fn():
                return ff.as_acc(v2.v2_acc(tgt, src, flavor=job["flavor"],
                                           p=p, block=512 // p, chunk=2048))
        else:
            p = 1

            def fn():
                return ff.as_acc(ff.flavor_acc(tgt, src, flavor=job["flavor"],
                                               p=1, block=512, chunk=2048))
        times = {"p": p}
    out = [fn().cpu()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms, **times}, out


def newton_job(job: dict, device, worlds: dict) -> tuple:
    """(times, [the (2, N) force]) of a "k5h" job."""
    from nbody_tpu_torch.ablations import _scene
    from nbody_tpu_torch.ops import newton_forces as nwf

    key = ("scene", job["n"])
    if key not in worlds:
        worlds.clear()
        worlds[key] = _scene.make_scene(job["n"], device=device)
    sc = worlds[key]
    tgt, src = sc.tgt4(), sc.src4(sc.s128)

    def fn():
        return nwf.newton_acc(tgt, src, sc.mass_len, tile=job["tile"])
    out = [torch.cat(fn()).cpu()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms}, out


def sweep_job(job: dict, device, worlds: dict) -> tuple:
    """(times, [the (2, N) force]) of a "k5g" or "k5e" job."""
    from nbody_tpu_torch.ablations import _scene
    from nbody_tpu_torch.ops import flavor_forces as ff
    from nbody_tpu_torch.ops import ptile_forces as ptf
    from nbody_tpu_torch.ops.direct_forces import sm_count

    key = ("scene", job["n"])
    if key not in worlds:
        worlds.clear()
        worlds[key] = _scene.make_scene(job["n"], device=device)
    sc = worlds[key]
    tgt, src = sc.tgt3(), sc.src3(sc.s128)
    sms = sm_count(device.index or 0) if device.type == "cuda" else 1
    if job["what"] == "k5g":
        p, block, chunk = job["p"], job["block"], job["chunk"]
        kw = {"n_split": job["n_split"]} if job.get("n_split") else {}

        def fn():
            return ptf.ptile_acc(tgt, src, p=p, block=block, chunk=chunk, **kw)
        times = {}
    else:
        (p, block), chunk = ff.shape(job["tile_t"]), job["chunk"]

        def fn():
            return ff.flavor_acc(tgt, src, flavor=job["flavor"], p=p,
                                 block=block, chunk=chunk)
        times = {"p": p}
    times["n_split"] = job.get("n_split") or ptf.split_plan(
        sc.n, sc.s128, p, block, chunk, sms)
    out = [torch.cat(fn()).cpu()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms, **times}, out


def run_job(job: dict, device, worlds: dict) -> tuple:
    """(times, output tensors or None) of one job."""
    if job["what"] == "k5h":
        return newton_job(job, device, worlds)
    if job["what"] in ("k5g", "k5e"):
        return sweep_job(job, device, worlds)
    if job["what"] == "v2":
        return v2_job(job, device, worlds)
    if job["what"] in ("k5a", "k5i"):
        return k5_job(job, device, worlds)
    if job["what"] in ("k5d", "k5c"):
        return stationary_probe_job(job, device, worlds)
    if job["what"] == "build":
        from nbody_tpu_torch.ops import _build

        _build.build_all(job["names"])
        return {}, None
    if job["what"] in ("contacts", "vjp", "merging", "rollout"):
        worlds.clear()
        return backward_job(job, device)
    if job["what"] == "ring":
        union, total, wall = ring_window(device, job["n"], job["d"])
        return {"union_ms": union, "sum_ms": total, "wall_ms": wall}, None
    if job["what"] in ("pp", "p3m", "pp_vjp", "p3m_rollout"):
        key = (job["n"], job["grid"], job["cap"])
        if key not in worlds:
            worlds.clear()
            worlds[key] = p3m_world(*key, device)
        world = worlds[key]
        if job["what"] in ("pp_vjp", "p3m_rollout"):
            fn = pp_vjp_call(world, job.get("precise", False)) \
                if job["what"] == "pp_vjp" else \
                p3m_rollout_call(world, job["steps"])
            out = [t.cpu() for t in fn()] if job.get("keep") else None
            scale = job.get("steps", 1)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = best_ms(fn, job.get("reps", 1), job.get("repeats", 3))
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            return {"ms": ms / scale, "device_ms": device_ms(fn) / scale,
                    "peak_mib": peak}, out
        if job["what"] == "p3m":
            return {"ms": p3m_substep_ms(world, job["substeps"],
                                         job.get("repeats", 2))}, None
        fn, to_rows = pp_call(world, job.get("precise", False))
        out = [to_rows(fn()).cpu()]
        ms = best_ms(fn, job["reps"], job.get("repeats", 3)) \
            if job.get("reps") else None
        return {"ms": ms}, out
    from nbody_tpu_torch.ops import direct_forces as df
    from nbody_tpu_torch.ops import ring_forces as rf

    n = job["n"]
    if n not in worlds:
        worlds.clear()
        worlds[n] = world_state(n, device)
    pos, vel, radius, gm = worlds[n]
    kw = {"precise": job.get("precise", False)}
    if job.get("plan"):
        kw["plan"] = tuple(job["plan"])
    if job["what"] == "fused":
        def fn():
            return df.fused_substep(1.0, pos, vel, radius, gm, **kw)
    else:
        valid = torch.ones(n, device=device)

        def fn():
            return rf.ring_hop(pos, radius, pos, gm, torch.empty_like(pos),
                               accumulate=False, vel=vel, valid=valid,
                               dt=1.0, **kw)
    out = [t.cpu() for t in fn()]
    ms = best_ms(fn, job["reps"], job.get("repeats", 3)) if job.get("reps") else None
    return {"ms": ms}, out


def main(argv: list[str]) -> None:
    jobs = json.loads(Path(argv[0]).read_text())
    out = Path(argv[1])
    device = torch.device("cuda")
    worlds: dict = {}
    for i, job in enumerate(jobs):
        times, tensors = run_job(job, device, worlds)
        if tensors is not None:
            torch.save(tensors, out / f"{i}.pt")
        print(json.dumps({"job": i, **times}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
