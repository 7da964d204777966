#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. environment: the card's name and power limit, torch and CUDA versions;
     requires a CUDA device of compute capability 9.0 (Hopper);
  1. build the CUDA kernel from nbody_tpu_torch/csrc (nvcc, sm_90a);
  2. the kernel against its plain PyTorch version on the card, at N=1000
     (random, ragged source count, no sources), the N=65536 bench scene,
     and the N=1M scene (the plain version on 4096 of its targets); the
     rsqrt and precise paths against float64;
  3. golden parity: the bit-exact reference IC (N=2000) stepped 20 and 100
     times through the kernel, against the reference binary's dumps;
  4. the main path at full width: N=65536, two galaxies, seed 11037,
     create_world -> update(1.0, 10) -> timed update(1.0, 100) ->
     particles, with the kernel's launch count; the plain "torch" backend
     timed the same way;
  5. N=1M: timed update_gpu substeps.
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


def phase_build(_build) -> None:
    log("[1] build")
    path, seconds = _build.build()
    _build.load()
    log(f"  {path.relative_to(ROOT)} built in {seconds:.1f} s")
    info = path.with_suffix(".log")
    if info.exists():
        for line in info.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"  {line.strip()}")


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
    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    log("[0] environment")
    smi = phase_env()
    device = torch.device(DEVICE)
    phase_build(_build)

    log("[2] kernel against its plain version on the card")
    pos, vel, radius, gm = random_state(1000, 333, device)
    compare_variants(df, "N=1000 S=333", pos, vel, radius, gm, BOUND_SMALL)
    compare_variants(df, "N=1000 S=0", pos, vel, radius, gm[:0], BOUND_SMALL)

    bench = nt.create_world(nt.make_galaxies(BENCH_N, 2, seed=SEED), device=device)
    st = bench.state
    err_bench = compare_variants(df, f"N={BENCH_N} S={bench.mass_len}", st.pos,
                                 st.vel, st.radius, bench.gm, BOUND_SMALL)
    rows = torch.from_numpy(
        np.random.default_rng(1).choice(BENCH_N, SUBSET, replace=False)).to(device)
    acc64 = accuracy_vs_fp64(df, forces, st.pos, st.radius, bench.gm, rows)

    big = nt.create_world(nt.make_galaxies(BIG_N, 2, seed=SEED), device=device)
    st = big.state
    rows = torch.from_numpy(
        np.random.default_rng(2).choice(BIG_N, SUBSET, replace=False)).to(device)
    err_big = compare_variants(df, f"N={BIG_N} S={big.mass_len} ({SUBSET} targets)",
                               st.pos, st.vel, st.radius, big.gm, BOUND_BIG,
                               rows=rows)

    phase_golden(nt, galaxy_ref, load_hex_dump, device)

    log(f"[4] main path: N={BENCH_N}, 2 galaxies, seed {SEED}, default config")
    world = nt.create_world(nt.make_galaxies(BENCH_N, 2, seed=SEED), device=device)
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
    plain = nt.create_world(nt.make_galaxies(BENCH_N, 2, seed=SEED), device=device)
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

    log(f"card: {smi}")
    log(f"rsqrt path vs fp64 at N={BENCH_N}: max|d|/max|a| {acc64['rsqrt'][0]:.3e}, "
        f"precise {acc64['precise'][0]:.3e}")
    log(json.dumps({"kernels": [
        {"name": f"direct_forces fused substep, N={BENCH_N} S={world.mass_len}",
         "route": "cuda", "source": KERNEL_SRC,
         "replaces": "nbody_tpu/ops/pallas_forces.py:220",
         "launches": launches_bench, "max_abs_err": err_bench,
         "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": f"direct_forces fused substep, N={BIG_N} S={big.mass_len}",
         "route": "cuda", "source": KERNEL_SRC,
         "replaces": "nbody_tpu/ops/pallas_forces.py:255",
         "launches": launches_big, "max_abs_err": err_big,
         "ms": big_ms, "plain_ms": big_plain_ms},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
