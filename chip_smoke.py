#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. environment: the card's name and power limit, torch and CUDA versions;
     requires a CUDA device of compute capability 9.0 (Hopper);
  1. build the CUDA kernels from nbody_tpu_torch/csrc (nvcc, sm_90a), one
     nvcc per source, all at once;
  2. the direct kernel against its plain PyTorch version on the card, at
     N=1000 (random, ragged source count, no sources), the N=65536 bench
     scene, and the N=1M scene (the plain version on 4096 of its targets);
     the rsqrt and precise paths against float64;
  3. golden parity: the bit-exact reference IC (N=2000) stepped 20 and 100
     times through the kernel, against the reference binary's dumps;
  4. the direct main path at full width: N=65536, two galaxies, seed 11037,
     create_world -> update(1.0, 10) -> timed update(1.0, 100) ->
     particles, with the kernel's launch count; the plain "torch" backend
     timed the same way;
  5. N=1M: timed update_gpu substeps;
  6. the P3M pair-correction kernel (K4) against its plain version: random
     cells, and the blocks the N=1M p3m world packs with the slice's config
     (grid 2048, cap 768) and with the default one (grid 512, cap 96);
  7. the direct kernel's source-split force_acc against its plain version:
     the 64 exact-core rows of the N=1M world against its 524,704 sources,
     and 1000 targets against 333 sources;
  8. the p3m main path: N=1M, two galaxies, seed 11037, pm_grid=2048,
     p3m_cell_capacity=768: create_world -> update(1.0, 1, backend="p3m")
     -> 10 timed substeps with no host sync -> particles, with both
     kernels' launch counts and a profiler window split by stage; then
     N=65536 with the default config, for time only;
  9. p3m accuracy against the direct kernel: the JAX package's envelope
     scene (N=2048, grid 256) and the N=1M slice config at its initial
     state, each bound fatal; then the sources and targets that full cells
     drop at the candidate p3m configs (no bound).
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 11037                    # the reference bench's seed (bench.c:42)
BENCH_N = 65536
BIG_N = 1 << 20
SUBSET = 4096                   # targets the plain version computes at N=1M
KERNEL_SRC = "nbody_tpu_torch/csrc/direct_forces.cu"
PP_SRC = "nbody_tpu_torch/csrc/p3m_pp.cu"
# The slice's p3m config at N=1M: the JAX defaults with the grid and the
# cell capacity sized by the package's overflow rule (PERF.md, "p3m sizing
# at N=1M"); and the defaults themselves.
P3M_SIZED = {"pm_grid": 2048, "p3m_cell_capacity": 768}
P3M_DEFAULT = {"pm_grid": 512, "p3m_cell_capacity": 96}
P3M_SUBSTEPS = 10
# K4 against its plain version: max|d|/max|ref| (fp32 sums of <= 9 cap
# terms in another order, FMA contraction, the hardware rsqrt).
BOUND_PP = 1e-5
# The source-split force_acc against its plain version.
BOUND_SPLIT_BIG = 2e-5          # T = 64, S = 524704
BOUND_SPLIT_SMALL = 5e-6        # T = 1000, S = 333
# p3m per-target error against the direct sum (tests/test_p3m.py:41-43)
P3M_MEDIAN, P3M_P99, P3M_MAX = 2e-3, 5e-2, 0.12
# The card's peaks (H100 SXM data sheet, 700 W): fp32 outside the tensor
# cores and HBM bandwidth; the bound of a function is the larger of its
# operations and its bytes over these.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Operations per pair: the direct sum as the TPU kernel counts it
# (pallas_forces.py:380), the P3M correction as p3m_pallas.py:120-125 does.
FLOPS_DIRECT = 13
FLOPS_PP = 14
STAGES = ("p3m.bins", "p3m.cic_scatter", "p3m.fft_solve", "p3m.cic_gather",
          "p3m.pack", "p3m.pair_kernel", "p3m.unpack", "p3m.exact_rows")
# Bounds on max|kernel - plain| / max|plain|: both are fp32 with the same
# formula; they differ in the order of the S-term sums, FMA contraction and
# the hardware rsqrt, so the bound grows with S. Measured on an H100:
# 2.8e-7 at N=1000, 1.3e-6 at N=65536, 2.6e-6 at N=1M (the 4096 targets).
BOUND_SMALL = 5e-6              # N <= 65536 (S <= 32833)
BOUND_BIG = 2e-5                # N = 1M (S = 524704)
# The fused epilogue against the plain update applied to the kernel's own
# force: only FMA contraction differs, ~1 ulp. (New positions against the
# plain version's would scale the force error by dt² max|a| / max|x|.)
BOUND_EPILOGUE = 1e-6
# tests/test_physics_validation.py:256-291: (steps, rel pos, rel vel)
GOLDEN_BOUNDS = ((20, 5e-7, 5e-6), (100, 1.5e-4, 3e-2))
GOLDEN = "tests/data/ref_traj_n2000_g2_seed11037_s{steps}_dt0.01.hex"
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def check(what: str, err: float, bound: float) -> None:
    ok = np.isfinite(err) and err < bound
    log(f"  {what}: max|d|/max|ref| = {err:.3e} (bound {bound:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {what} out of bound")


def cuda_ms(fn, reps: int = 1) -> float:
    """Device milliseconds per call of fn, from CUDA events around reps calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"capability {cap}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    # The plain versions use no matmul or convolution, but pin full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what sets it): the least time the card could take for this
    many fp32 operations and bytes moved."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_build(_build) -> None:
    log("[1] build")
    t0 = time.perf_counter()
    built = _build.build_all()
    for name in built:
        _build.load(name)
    log(f"  all sources built in {time.perf_counter() - t0:.1f} s")
    for name, (path, seconds) in built.items():
        log(f"  {path.relative_to(ROOT)}: nvcc {seconds:.1f} s")
        info = path.with_suffix(".log")
        if info.exists():
            for line in info.read_text().splitlines():
                if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                    log(f"    {line.strip()}")


def random_state(n: int, n_src: int, device) -> tuple:
    """N random particles: 30% zero-radius tracers, n_src massive sources."""
    rng = np.random.default_rng(0)
    pos = (100 * rng.normal(size=(n, 2))).astype(np.float32)
    vel = rng.normal(size=(n, 2)).astype(np.float32)
    radius = rng.uniform(1.5, 9.5, n).astype(np.float32)
    radius[rng.uniform(size=n) < 0.3] = 0.0
    gm = (10 * rng.uniform(10, 1e4, n_src)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (pos, vel, radius, gm))


def compare_variants(df, label, pos, vel, radius, gm, bound, rows=None) -> float:
    """force_acc and fused_substep (pos_dt 1 and 0.5, precise and rsqrt)
    against the plain version; with ``rows`` the plain version computes
    only those targets. Returns the largest max|d acc|."""
    worst = 0.0
    n_src = gm.shape[0]
    src = pos[:n_src]
    rows = torch.arange(pos.shape[0], device=pos.device) if rows is None else rows
    tp, tr, tv = pos[rows], radius[rows], vel[rows]

    def check_acc(what, got, want):
        nonlocal worst
        if n_src == 0:
            if not torch.equal(got, torch.zeros_like(got)):
                raise SystemExit(f"chip_smoke: {what} with no sources is not 0")
            log(f"  {what}: exactly 0 with no sources ok")
            return
        check(what, rel(got, want), bound)
        worst = max(worst, float((got - want).abs().max()))

    for precise in (False, True):
        tag = "precise" if precise else "rsqrt"
        want = df.force_acc_plain(tp, tr, src, gm, precise=precise)
        check_acc(f"{label} force_acc {tag}",
                  df.force_acc(tp, tr, src, gm, precise=precise), want)
        for pos_dt in (1.0, 0.5):
            npos, nvel, acc = (x[rows] for x in df.fused_substep(
                0.01, pos, vel, radius, gm, precise=precise, pos_dt=pos_dt))
            what = f"{label} fused_substep {tag} pos_dt={pos_dt}"
            check_acc(f"{what} acc", acc, want)
            check(f"{what} vel (epilogue)", rel(nvel, tv + 0.01 * acc),
                  BOUND_EPILOGUE)
            check(f"{what} pos (epilogue)",
                  rel(npos, tp + df._pos_dt_times_dt(pos_dt, 0.01) * nvel),
                  BOUND_EPILOGUE)
    return worst


def accuracy_vs_fp64(df, forces, pos, radius, gm, rows) -> dict:
    """The kernel's force on ``rows`` against a float64 evaluation."""
    src = pos[:gm.shape[0]]
    want = forces.direct_sum_acc(pos[rows].double(), radius[rows].double(),
                                 src.double(), gm.double(), precise=True)
    out = {}
    for precise in (False, True):
        got = df.force_acc(pos[rows].contiguous(), radius[rows].contiguous(),
                           src, gm, precise=precise).double()
        per_row = (got - want).norm(dim=1) / want.norm(dim=1)
        tag = "precise" if precise else "rsqrt"
        out[tag] = (rel(got, want), float(per_row.median()), float(per_row.max()))
        log(f"  {tag} kernel vs fp64 on {len(rows)} targets: "
            f"max|d|/max|a| = {out[tag][0]:.3e}, per-target |d|/|a| median "
            f"{out[tag][1]:.3e} max {out[tag][2]:.3e}")
    return out


def phase_golden(nt, galaxy_ref, load_hex_dump, device) -> None:
    log("[3] golden parity through the kernel (bit-exact IC, precise=True)")
    if not galaxy_ref.available():
        raise SystemExit("chip_smoke: the platform libm is not available")
    ic = galaxy_ref.make_galaxies_libc(2000, 2, seed=SEED)
    perm, _ = nt.partition_massive_first(ic.mass)
    for steps, pos_bound, vel_bound in GOLDEN_BOUNDS:
        golden = load_hex_dump(ROOT / GOLDEN.format(steps=steps))[perm.numpy()]
        world = nt.create_world(ic, config=nt.SimConfig(precise=True), device=device)
        world.update_gpu(0.01, steps)
        got = world.particles
        if not (np.array_equal(got.mass.numpy(), golden[:, 4])
                and np.array_equal(got.radius.numpy(), golden[:, 5])):
            raise SystemExit("chip_smoke: golden mass/radius not bitwise equal")
        dpos = float(np.abs(got.pos.numpy() - golden[:, :2]).max()
                     / np.abs(golden[:, :2]).max())
        dvel = float(np.abs(got.vel.numpy() - golden[:, 2:4]).max()
                     / np.abs(golden[:, 2:4]).max())
        check(f"{steps} steps rel pos", dpos, pos_bound)
        check(f"{steps} steps rel vel", dvel, vel_bound)


def time_update(world, n: int, backend: str) -> tuple[float, float]:
    """(host µs, device µs) per substep of world.update(1.0, n, backend)."""
    world.block_until_ready()
    t0 = time.perf_counter()
    dev_ms = cuda_ms(lambda: world.update(1.0, n, backend=backend))
    host_s = time.perf_counter() - t0
    return host_s / n * 1e6, dev_ms / n * 1e3


def live_pairs(counts_t, counts_s, gc: int, cap_t: int, cap_s: int) -> dict:
    """What the K4 launch must do on these counts: live pairs (live target
    slots x live source slots of their 9 neighbour cells), the live slots,
    and the dense pair slots of the blocks."""
    ct = counts_t.reshape(gc, gc).clamp(max=cap_t).double()
    cs = counts_s.reshape(gc, gc).clamp(max=cap_s).double()
    csp = torch.nn.functional.pad(cs, (1, 1, 1, 1))
    nsum = sum(csp[i:i + gc, j:j + gc] for i in range(3) for j in range(3))
    return {"pairs": int((ct * nsum).sum()), "live_t": int(ct.sum()),
            "live_s": int(cs.sum()), "dense": gc * gc * cap_t * 9 * cap_s,
            "cells_with_targets": int((ct > 0).sum())}


def pp_bound(gc: int, cap_t: int, live: dict) -> tuple[float, str]:
    """K4's bound: 14 operations per live pair; the live (x, y, r|gm) slots
    and both counts read once, the dense (gc², cap_t, 2) output written."""
    nbytes = 12 * (live["live_t"] + live["live_s"]) + 8 * gc * gc \
        + 8 * gc * gc * cap_t
    return bound(FLOPS_PP * live["pairs"], nbytes)


def world_blocks(p3m_forces, world):
    """The cell blocks, rc and counts that world.update(backend="p3m")
    packs from the world's current state."""
    cfg, st, s = world.config, world.state, world.mass_len
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], world.gm,
                               grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                               exact_targets=0)
    gc, cap = cfg.pm_grid // cfg.p3m_rc_cells, cfg.p3m_cell_capacity
    src = p3m_forces._pack_source_blocks(st.pos[:s], world.gm,
                                         bins["order_s"], bins["counts_s"],
                                         gc, cap)
    trow = torch.cat([st.pos, st.radius[:, None]], -1)[bins["order_t"]]
    tgt = p3m_forces._gather_blocks(
        [(trow[:, 0], 0.0), (trow[:, 1], 0.0), (trow[:, 2], 1.0)],
        bins["counts_t"], gc, cap)
    return ([*tgt, *src], cfg.p3m_rc_cells * bins["h"], bins["counts_t"],
            bins["counts_s"])


def random_blocks(device, gc: int = 8, cap: int = 32):
    """Random cells: slots inside their own cell of a grid of cell size 4
    (rc = 4), a random number of live slots per cell, gm 0 elsewhere."""
    rng = np.random.default_rng(0)
    ij = np.stack(np.meshgrid(np.arange(gc), np.arange(gc), indexing="ij"), -1)
    counts = [rng.integers(0, cap + 1, gc * gc).astype(np.int32) for _ in range(2)]
    txy, sxy = ((ij[:, :, None, :] + rng.uniform(size=(gc, gc, cap, 2))) * 4.0
                for _ in range(2))
    live_s = (np.arange(cap)[None, :] < counts[1][:, None]).reshape(gc, gc, cap)
    tr = rng.uniform(0.5, 9.5, (gc, gc, cap))
    sg = np.where(live_s, rng.uniform(10, 1e4, (gc, gc, cap)), 0.0)
    arrays = (txy[..., 0], txy[..., 1], tr, sxy[..., 0], sxy[..., 1], sg)
    blocks = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
              for a in arrays]
    return blocks, 4.0, *(torch.from_numpy(c).to(device) for c in counts)


def compare_pp(pp, label, blocks, rc, counts_t, counts_s, dense_plain: bool) -> dict:
    """K4 against pp_blocks_plain, rsqrt and precise, with and without the
    counts. With ``dense_plain`` the plain version computes every slot;
    otherwise (the slice's 262144 cells) only the cells holding targets,
    and the kernel's all-slot output is held to it on the live slots.
    Returns the largest max|d| and the timings of the counted rsqrt call."""
    gc, _, cap_t = blocks[0].shape
    cap_s = blocks[3].shape[-1]
    live = live_pairs(counts_t, counts_s, gc, cap_t, cap_s)
    slot = torch.arange(cap_t, device=counts_t.device)
    live_slots = slot[None, :] < counts_t.reshape(-1, 1)
    worst = 0.0
    kw = {"counts_t": counts_t, "counts_s": counts_s}
    for precise in (False, True):
        tag = "precise" if precise else "rsqrt"
        t0 = time.perf_counter()
        want_c = pp.pp_blocks_plain(*blocks, rc, 4.0, precise=precise, **kw)
        torch.cuda.synchronize()
        if not precise:
            plain_ms = (time.perf_counter() - t0) * 1e3
        got_c = pp.pp_blocks(*blocks, rc, 4.0, precise=precise, **kw)
        check(f"{label} {tag} with counts", rel(got_c, want_c), BOUND_PP)
        got_a = pp.pp_blocks(*blocks, rc, 4.0, precise=precise)
        if not torch.isfinite(got_a).all():
            raise SystemExit(f"chip_smoke: {label} {tag} all slots not finite")
        if dense_plain:
            want_a = pp.pp_blocks_plain(*blocks, rc, 4.0, precise=precise)
            check(f"{label} {tag} all slots", rel(got_a, want_a), BOUND_PP)
        else:
            want_a = want_c
            check(f"{label} {tag} all slots, on the live slots",
                  rel(got_a[live_slots], want_c[live_slots]), BOUND_PP)
            got_a = torch.where(live_slots[..., None], got_a, 0.0)
        worst = max(worst, float((got_c - want_c).abs().max()),
                    float((got_a - want_a).abs().max()))
    ms = cuda_ms(lambda: pp.pp_blocks(*blocks, rc, 4.0, **kw), reps=20)
    ms_all = cuda_ms(lambda: pp.pp_blocks(*blocks, rc, 4.0), reps=5)
    bound_ms, bound_by = pp_bound(gc, cap_t, live)
    log(f"  {label}: {live['cells_with_targets']} of {gc * gc} cells hold "
        f"targets; live pairs {live['pairs']:.4e} of {live['dense']:.4e} dense "
        f"slots; kernel {ms:.4f} ms with counts, {ms_all:.4f} ms all slots; "
        f"plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
        f"{FLOPS_PP * live['pairs'] / (ms * 1e-3) / 1e12:.3f} TFLOP/s")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_pp(pp, p3m_forces, slice_w, default_w, device) -> dict:
    log("[6] K4 (P3M pair correction) against its plain version on the card")
    out = {}
    blocks, rc, ct, cs = random_blocks(device)
    compare_pp(pp, "random 8x8 cells cap 32", blocks, rc, ct, cs, True)
    for key, world, dense in (("sized", slice_w, False),
                              ("default", default_w, True)):
        cfg = world.config
        blocks, rc, ct, cs = world_blocks(p3m_forces, world)
        out[key] = compare_pp(
            pp, f"N={world.total_len} grid {cfg.pm_grid} gc="
            f"{cfg.pm_grid // cfg.p3m_rc_cells} cap={cfg.p3m_cell_capacity}",
            blocks, rc, ct, cs, dense)
        del blocks
    return out


def phase_split(df, p3m_forces, slice_w, device) -> dict:
    log("[7] source-split force_acc against its plain version on the card")
    st, s = slice_w.state, slice_w.mass_len
    rows = p3m_forces.exact_core_rows(st.radius, slice_w.config.p3m_exact_targets)
    tp, tr = st.pos[rows].contiguous(), st.radius[rows].contiguous()
    src, gm = st.pos[:s], slice_w.gm
    t = tp.shape[0]
    n_split = df._split_plan(t, s, df.sm_count(device.index or 0))
    worst = 0.0
    for precise in (False, True):
        got = df.force_acc(tp, tr, src, gm, precise=precise)
        want = df.force_acc_plain(tp, tr, src, gm, precise=precise)
        check(f"exact-core rows T={t} S={s} ({n_split} splits) "
              f"{'precise' if precise else 'rsqrt'}", rel(got, want),
              BOUND_SPLIT_BIG)
        worst = max(worst, float((got - want).abs().max()))
    ms = cuda_ms(lambda: df.force_acc(tp, tr, src, gm), reps=20)
    plain_ms = cuda_ms(lambda: df.force_acc_plain(tp, tr, src, gm), reps=3)
    acc = torch.empty_like(tp)
    single_ms = cuda_ms(lambda: df._launch(tp, None, tr, src, gm, 0.0, 1.0,
                                           False, acc, None, None), reps=3)
    bound_ms, bound_by = bound(FLOPS_DIRECT * t * s, 20 * t + 12 * s)
    log(f"  exact-core rows: split kernel {ms:.4f} ms, one-launch form "
        f"{single_ms:.4f} ms ({-(-t // df.BLOCK)} block), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    if not ms < plain_ms:
        raise SystemExit("chip_smoke: the split force_acc is not faster than "
                         "its plain version at the exact-core rows")
    pos, _, radius, gm_small = random_state(1000, 333, device)
    for precise in (False, True):
        check(f"T=1000 S=333 {'precise' if precise else 'rsqrt'}",
              rel(df.force_acc(pos, radius, pos[:333], gm_small, precise=precise),
                  df.force_acc_plain(pos, radius, pos[:333], gm_small,
                                     precise=precise)), BOUND_SPLIT_SMALL)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "single_ms": single_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "t": t, "s": s}


def profile_stages(world, n: int = 3) -> dict:
    """Device and host ms per substep of each p3m stage, the device busy
    time and the idle share of a torch.profiler window over n substeps.
    A stage's device time is that of the kernels, copies and fills that run
    inside the span its record_function range has on the device timeline;
    its host time is the range's own. (The kernels launched through ctypes
    are on the device timeline but linked to no host-side op, so the host
    ranges' device totals would miss them.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    world.block_until_ready()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        world.update(1.0, n, backend="p3m")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in dev if e.name in STAGES]
    work = [(e.time_range.start, e.time_range.end)
            for e in dev if e.name not in STAGES]
    busy_ms = sum(b - a for a, b in work) / 1e3
    stages = {name: sum(b - a for a, b in work
                        if any(nm == name and lo <= a and b <= hi
                               for nm, lo, hi in spans)) / n / 1e3
              for name in STAGES}
    host = {name: sum(e.cpu_time_total for e in events
                      if e.device_type == DeviceType.CPU and e.name == name)
            / n / 1e3 for name in STAGES}
    if busy_ms <= 0 or stages["p3m.pair_kernel"] <= 0:
        raise SystemExit("chip_smoke: the profiler saw no device time per stage")
    return {"stages": stages, "host": host, "busy_ms": busy_ms / n,
            "wall_ms": wall_ms / n, "idle": 1.0 - busy_ms / wall_ms}


def run_p3m(df, pp, world, label: str) -> dict:
    """Warm-up substep, then P3M_SUBSTEPS timed substeps with both launch
    counts from 0 and host syncs turned into errors."""
    world.update(1.0, 1, backend="p3m")
    world.block_until_ready()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    df.LAUNCHES = pp.LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        world.update(1.0, P3M_SUBSTEPS, backend="p3m")
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = {"force_acc": df.LAUNCHES, "pp": pp.LAUNCHES}
    if launches != {"force_acc": P3M_SUBSTEPS, "pp": P3M_SUBSTEPS}:
        raise SystemExit(f"chip_smoke: {label}: expected {P3M_SUBSTEPS} "
                         f"launches of each kernel, got {launches}")
    p = world.particles
    if not all(torch.isfinite(x).all() for x in (p.pos, p.vel, p.acc)):
        raise SystemExit(f"chip_smoke: non-finite state after {label}")
    ms = start.elapsed_time(end) / P3M_SUBSTEPS
    log(f"  {label}: {ms:.4f} ms/substep device, host {enqueue_ms / P3M_SUBSTEPS:.4f}"
        f" ms/substep to enqueue and {host_ms / P3M_SUBSTEPS:.4f} to finish; "
        f"launches K4 {launches['pp']}, force_acc {launches['force_acc']}; "
        f"no host sync")
    return {"ms": ms, "launches": launches}


def phase_p3m(nt, df, pp, scene_big, scene_bench, device, direct_big_ms) -> dict:
    log(f"[8] p3m main path: N={BIG_N}, 2 galaxies, seed {SEED}, "
        f"{P3M_SIZED}")
    world = nt.create_world(scene_big, config=nt.SimConfig(**P3M_SIZED),
                            device=device)
    out = run_p3m(df, pp, world, f"N={BIG_N} slice config")
    prof = profile_stages(world)
    log(f"  profiler over 3 substeps: device busy {prof['busy_ms']:.4f} ms of "
        f"{prof['wall_ms']:.4f} ms wall per substep, idle {prof['idle']:.2%}. "
        f"Per substep by stage, device ms (share of busy) and host ms:")
    for name, ms in prof["stages"].items():
        log(f"    {name:18s} device {ms:9.4f} ms {ms / prof['busy_ms']:6.1%}"
            f"   host {prof['host'][name]:8.4f} ms")
    other = prof["busy_ms"] - sum(prof["stages"].values())
    log(f"    {'other (integrate)':18s} device {other:9.4f} ms")
    log(f"  without the profiler: device {out['ms']:.4f} ms/substep (CUDA "
        f"events), so the device is idle about "
        f"{1 - prof['busy_ms'] / out['ms']:.1%} of it")
    log(f"  direct kernel at N={BIG_N} ([5]): {direct_big_ms:.4f} ms/substep, "
        f"{direct_big_ms / out['ms']:.2f}x the p3m substep")
    out["profile"] = prof
    small = nt.create_world(scene_bench, config=nt.SimConfig(**P3M_DEFAULT),
                            device=device)
    out["bench"] = run_p3m(df, pp, small, f"N={BENCH_N} default config (time only)")
    return out


def p3m_errors(got, ref) -> np.ndarray:
    """Per-target relative error (tests/test_p3m.py:20-31)."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    mag = np.hypot(ref[:, 0], ref[:, 1])
    return np.hypot(*(got - ref).T) / (mag + 0.01 * mag.mean())


def check_errors(label: str, err: np.ndarray, bounds: dict) -> None:
    stats = {"median": np.median(err), "p99": np.percentile(err, 99),
             "max": err.max()}
    text = ", ".join(f"{k} {v:.3e}" + (f" (bound {bounds[k]:g})" if k in bounds
                                       else "") for k, v in stats.items())
    ok = all(np.isfinite(v) and v < bounds[k] for k, v in stats.items()
             if k in bounds)
    log(f"  {label}: per-target error {text} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: p3m accuracy out of bound: {label}")


# (N, pm_grid, p3m_cell_capacity) whose cell overflow [9] counts: the
# defaults and the candidates for sizing the p3m config at N=1M, and the
# other sizes of docs/BENCHMARKS.md's p3m rows.
SIZING = ((BIG_N, 512, 96), (BIG_N, 1024, 1536), (BIG_N, 2048, 384),
          (BIG_N, 2048, 768), (BENCH_N, 512, 96), (1 << 18, 2048, 384))


def sizing_table(nt, p3m_forces, device) -> None:
    """Sources and targets dropped from full cells at each SIZING config,
    two galaxies, seed 11037, initial state: the counts of the bins that
    world.update(backend="p3m") builds."""
    scenes = {}
    for n, grid, cap in SIZING:
        if n not in scenes:
            scenes[n] = nt.create_world(nt.make_galaxies(n, 2, seed=SEED),
                                        device=device)
        w = scenes[n]
        st, s = w.state, w.mass_len
        bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], w.gm,
                                   grid=grid, rc_cells=4, exact_targets=0)
        drop_s, drop_t = (int(torch.clamp(bins[k] - cap, min=0).sum())
                          for k in ("counts_s", "counts_t"))
        log(f"  N={n} pm_grid={grid} cap={cap}: {drop_s} of {s} sources "
            f"({drop_s / s:.2%}) and {drop_t} of {n} targets dropped")


def phase_accuracy(nt, df, slice_w, device) -> None:
    log("[9] p3m accuracy against the direct kernel (precise)")
    w = nt.create_world(nt.make_galaxies(2048, 2, seed=SEED), device=device)
    pos, rad, src, gm = w.state.pos, w.state.radius, w.state.pos[:w.mass_len], w.gm
    got = nt.p3m_acc(pos, rad, src, gm, 2.0, grid=256)
    ref = df.force_acc(pos, rad, src, gm, precise=True)
    check_errors("N=2048 grid 256, all targets", p3m_errors(got, ref),
                 {"median": P3M_MEDIAN, "p99": P3M_P99, "max": P3M_MAX})
    cfg, st, s = slice_w.config, slice_w.state, slice_w.mass_len
    kw = dict(grid=cfg.pm_grid, cell_capacity=cfg.p3m_cell_capacity)
    got = nt.p3m_acc(st.pos, st.radius, st.pos[:s], slice_w.gm, 2.0, **kw)
    rows = torch.from_numpy(np.random.default_rng(3).choice(
        slice_w.total_len, SUBSET, replace=False)).to(device)
    ref = df.force_acc(st.pos[rows], st.radius[rows], st.pos[:s], slice_w.gm,
                       precise=True)
    check_errors(f"N={slice_w.total_len} {P3M_SIZED}, {SUBSET} targets",
                 p3m_errors(got[rows], ref),
                 {"median": P3M_MEDIAN, "p99": P3M_P99})
    overflow = int(nt.p3m_cell_overflow(st.pos[:s], slice_w.gm, **kw))
    log(f"  p3m_cell_overflow: {overflow} of {s} sources dropped from full "
        f"cells (the box of the sources alone)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nbody_tpu_torch as nt
    from nbody_tpu_torch import forces
    from nbody_tpu_torch.models import galaxy_ref
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import direct_forces as df
    from nbody_tpu_torch.ops import p3m_forces
    from nbody_tpu_torch.ops import p3m_pp as pp
    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    log("[0] environment")
    smi = phase_env()
    device = torch.device(DEVICE)
    phase_build(_build)

    log("[2] kernel against its plain version on the card")
    pos, vel, radius, gm = random_state(1000, 333, device)
    compare_variants(df, "N=1000 S=333", pos, vel, radius, gm, BOUND_SMALL)
    compare_variants(df, "N=1000 S=0", pos, vel, radius, gm[:0], BOUND_SMALL)

    scene_bench = nt.make_galaxies(BENCH_N, 2, seed=SEED)
    scene_big = nt.make_galaxies(BIG_N, 2, seed=SEED)
    bench = nt.create_world(scene_bench, device=device)
    st = bench.state
    err_bench = compare_variants(df, f"N={BENCH_N} S={bench.mass_len}", st.pos,
                                 st.vel, st.radius, bench.gm, BOUND_SMALL)
    rows = torch.from_numpy(
        np.random.default_rng(1).choice(BENCH_N, SUBSET, replace=False)).to(device)
    acc64 = accuracy_vs_fp64(df, forces, st.pos, st.radius, bench.gm, rows)

    big = nt.create_world(scene_big, device=device)
    st = big.state
    rows = torch.from_numpy(
        np.random.default_rng(2).choice(BIG_N, SUBSET, replace=False)).to(device)
    err_big = compare_variants(df, f"N={BIG_N} S={big.mass_len} ({SUBSET} targets)",
                               st.pos, st.vel, st.radius, big.gm, BOUND_BIG,
                               rows=rows)

    phase_golden(nt, galaxy_ref, load_hex_dump, device)

    log(f"[4] main path: N={BENCH_N}, 2 galaxies, seed {SEED}, default config")
    world = nt.create_world(scene_bench, device=device)
    df.LAUNCHES = 0
    world.update(1.0, 10)
    world.block_until_ready()
    t0 = time.perf_counter()
    main_ms = cuda_ms(lambda: world.update(1.0, 100)) / 100
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    launches_bench = df.LAUNCHES
    p = world.particles
    if launches_bench != 110:
        raise SystemExit(f"chip_smoke: expected 110 kernel launches, got {launches_bench}")
    if not all(torch.isfinite(x).all() for x in (p.pos, p.vel, p.acc)):
        raise SystemExit("chip_smoke: non-finite state after the main path")
    pairs = BENCH_N * world.mass_len
    log(f"  kernel: {host_us:.1f} µs/substep host, {main_ms * 1e3:.1f} µs/substep "
        f"device, {pairs / (main_ms * 1e-3):.4e} pairs/s, launches {launches_bench}")
    # in turns: plain, kernel, kernel, plain (the kernel on the main-path
    # world, the plain version on a fresh world of the same scene)
    plain = nt.create_world(scene_bench, device=device)
    plain.update(1.0, 2, backend="torch")
    runs = {"torch": [], "cuda": []}
    for backend, n in (("torch", 10), ("cuda", 100), ("cuda", 100), ("torch", 10)):
        w = plain if backend == "torch" else world
        runs[backend].append(time_update(w, n, backend))
    for backend, got in runs.items():
        for host, dev in got:
            log(f"  {backend:5s}: {host:.1f} µs/substep host, {dev:.1f} µs/substep "
                f"device, {pairs / (dev * 1e-6):.4e} pairs/s")
    plain_ms = float(np.mean([dev for _, dev in runs["torch"]])) / 1e3
    kernel_ms = float(np.mean([dev for _, dev in runs["cuda"]])) / 1e3

    log(f"[5] N={BIG_N}: update_gpu")
    big_pairs = BIG_N * big.mass_len
    df.LAUNCHES = 0
    big.update_gpu(1.0, 1)
    big_ms = cuda_ms(lambda: big.update_gpu(1.0, 3)) / 3
    launches_big = df.LAUNCHES
    p = big.particles
    if launches_big != 4:
        raise SystemExit(f"chip_smoke: expected 4 kernel launches, got {launches_big}")
    if not all(torch.isfinite(x).all() for x in (p.pos, p.vel, p.acc)):
        raise SystemExit("chip_smoke: non-finite state at N=1M")
    log(f"  kernel: {big_ms:.2f} ms/substep, {big_pairs / (big_ms * 1e-3):.4e} "
        f"pairs/s, launches {launches_big}")
    big_plain_ms = cuda_ms(lambda: big.update(1.0, 1, backend="torch"))
    log(f"  plain: {big_plain_ms:.1f} ms/substep")

    slice_w = nt.create_world(scene_big, config=nt.SimConfig(**P3M_SIZED),
                              device=device)
    default_w = nt.create_world(scene_big, config=nt.SimConfig(**P3M_DEFAULT),
                                device=device)
    k4 = phase_pp(pp, p3m_forces, slice_w, default_w, device)
    del default_w
    split = phase_split(df, p3m_forces, slice_w, device)
    p3m = phase_p3m(nt, df, pp, scene_big, scene_bench, device, big_ms)
    phase_accuracy(nt, df, slice_w, device)
    sizing_table(nt, p3m_forces, device)

    log(f"card: {smi}")
    log(f"rsqrt path vs fp64 at N={BENCH_N}: max|d|/max|a| {acc64['rsqrt'][0]:.3e}, "
        f"precise {acc64['precise'][0]:.3e}")
    log(f"p3m ms/substep: N={BIG_N} slice config {p3m['ms']:.4f} (direct "
        f"{big_ms:.4f}); N={BENCH_N} default config {p3m['bench']['ms']:.4f} "
        f"(direct {kernel_ms:.4f})")

    def fused_row(n, s, replaces, launches, err, ms, plain):
        b_ms, b_by = bound(FLOPS_DIRECT * n * s, 44 * n + 4 * s)
        return {"name": f"direct_forces fused substep, N={n} S={s}",
                "route": "cuda", "source": KERNEL_SRC, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    def pp_row(key, cfg, launches):
        r = k4[key]
        return {"name": f"p3m_pp pair correction, gc={cfg['pm_grid'] // 4} "
                        f"cap={cfg['p3m_cell_capacity']}, N={BIG_N} blocks",
                "route": "cuda", "source": PP_SRC,
                "replaces": "nbody_tpu/ops/p3m_pallas.py:38",
                "launches": launches, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    log(json.dumps({"kernels": [
        fused_row(BENCH_N, world.mass_len, "nbody_tpu/ops/pallas_forces.py:220",
                  launches_bench, err_bench, kernel_ms, plain_ms),
        fused_row(BIG_N, big.mass_len, "nbody_tpu/ops/pallas_forces.py:255",
                  launches_big, err_big, big_ms, big_plain_ms),
        {"name": f"direct_forces force_acc, source split, P3M exact-core rows "
                 f"T={split['t']} S={split['s']}",
         "route": "cuda", "source": KERNEL_SRC,
         "replaces": "nbody_tpu/ops/pallas_forces.py:255",
         "launches": p3m["launches"]["force_acc"],
         "max_abs_err": split["max_abs_err"], "ms": split["ms"],
         "plain_ms": split["plain_ms"], "bound_ms": split["bound_ms"],
         "bound_by": split["bound_by"], "library_ms": None},
        pp_row("sized", P3M_SIZED, p3m["launches"]["pp"]),
        pp_row("default", P3M_DEFAULT, p3m["bench"]["launches"]["pp"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
