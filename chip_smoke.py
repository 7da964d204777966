#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  0. environment: the card's name and power limit, torch and CUDA versions;
     requires a CUDA device of compute capability 9.0 (Hopper);
  1. build the CUDA kernels from nbody_tpu_torch/csrc (nvcc, sm_90a), one
     nvcc per source, all at once; the main-path kernels' pair loop (SASS
     instructions a pair) and their registers and spill bytes, for each P;
  2. the direct kernel against its plain PyTorch version on the card, at
     N=1000 (random, ragged source count, no sources; and with each P and
     a forced cluster split), the N=65536 bench scene, and the N=1M scene
     (the plain version on 4096 of its targets); the rsqrt and precise
     paths against float64. [2], [4], [5], [7], [10] and [12] print the
     plan (P, n_split, cluster size, chunk) of each kernel launch;
  3. golden parity: the bit-exact reference IC (N=2000) stepped 20 and 100
     times through the kernel, against the reference binary's dumps;
  4. the direct main path at full width: N=65536, two galaxies, seed 11037,
     create_world -> update(1.0, 10) -> timed update(1.0, 100) ->
     particles, with the kernel's launch count; the plain "torch" backend
     timed the same way;
  5. N=1M: timed update_gpu substeps;
  6. the P3M pair-correction kernel (K4) against its plain version, rsqrt
     and precise: pp_cells (the main path's cells route) against
     pp_cells_plain, and pp_blocks on the same cells with and without the
     counts against pp_blocks_plain, its live rows compared bit for bit
     with the cells route's, on random 8x8 cells (cap 32, an empty cell
     and cells past the cap), the cells of the N=1M p3m world with the
     slice's config (grid 2048, gc 512, cap 768) and of the N=65536 world
     with the default one (grid 512, gc 128, cap 96); with each scene's
     candidate pairs, pairs inside rc, tasks, lanes busy (by tasks, and
     by work: candidates over 32 × warp iterations), K4's time and bound;
  7. the direct kernel's source-split force_acc against its plain version:
     the 64 exact-core rows of the N=1M world against its 524,704 sources,
     and 1000 targets against 333 sources;
  8. the p3m main path: N=1M, two galaxies, seed 11037, pm_grid=2048,
     p3m_cell_capacity=768: create_world -> update(1.0, 1, backend="p3m")
     -> 10 timed substeps with no host sync -> particles, with both
     kernels' launch counts and a profiler window split by stage; then
     the pack's row gather timed against a gather of fp32 rows (bit-equal);
     N=65536 with the default config, for time only; then a "pm" and a
     "p3m" World at N=1M each run twice from the same state, bit-equal,
     and the CIC scatter timed against the index_add_ form it replaced;
  9. p3m accuracy against the direct kernel: the JAX package's envelope
     scene (N=2048, grid 256) and the N=1M slice config at its initial
     state, each bound fatal; then the sources and targets that full cells
     drop at the candidate p3m configs (no bound);
 10. the ring hop kernel (K3) against its plain version: N=1000 targets, a
     slot of 400 rows with 333 real sources and with none, rsqrt and
     precise, a middle hop and a last hop with pos_dt 1 and 0.5; each P
     with a forced cluster split;
 11. the race check: ShardedWorld with force_backend "cuda_ring" and
     "cuda", each with D = 2, 3, 4 and 8 shards on one card at N=65536 for
     5 substeps, bit-equal to the same run with the card synchronised after
     every hop and copy; against the single-device World: D=1 bit-equal
     after 10 substeps, D=4 after 10 substeps on eight seeds and on one
     evaluation of the same state; golden parity of the bit-exact IC
     through "cuda_ring" at D=4;
 12. the sharded main path at full width on one card: N=65536 with D=1 and
     D=4, and N=1M with D=4: ShardedWorld -> update(1.0, 2) -> timed update
     with no host sync and exactly D² hop launches per substep ->
     particles (finite), for "cuda_ring" and "cuda"; each backend's kernel
     against its plain version at the path's shapes; a profiler window
     that sums the hop kernel's device time; the "torch" backend timed
     beside them;
 13. the ablation path of the direct force at N=65536 (two galaxies, seed
     11037): each of K5a (on K5b's kernel, csrc/v2_forces.cu, its rsqrt
     and precise paths), K5g, K5d and K5h through its module in
     nbody_tpu_torch.ablations at the module's sweep (K5g, K5d and K5h on
     K5b's pair step, csrc/pair_step.cuh; K5g on its chunked sweep, whose
     stage, SASS a pair, registers and spills are printed beside its
     row), every configuration against its
     plain version and run twice for bit-equality, timed with
     CUDA events beside K1's force_acc on the same inputs (and K5a's
     50-substep loop beside World.update), with the four launch counts;
     K5h's task plan (tasks, warps an SM) and its dual and forward loops'
     SASS a pair beside its row; then K5h at a ragged N=50000 against the
     plain direct sum;
 14. the rest of the ablation path, with the four launch counts from 0:
     K5b's eight micro-variants through its own kernel (csrc/v2_forces.cu,
     after its pair loop's SASS a pair and registers per flavor at P = 1
     and 2; each also as a 50-substep loop beside World.update), then
     K5e's seven reductions at N=65536 through the flavored chunk kernel
     (K5g's chunked sweep; stage, SASS a pair, registers and spills beside
     its row),
     and K5c's eight op-cost probes through K5b's kernel as row variants
     (with each pair loop's SASS a pair at P = 1 and 2), K5b's, K5c's and
     K5e's launch counts kept apart; K5f's nine expressions at (256,
     2048), LO and HI loops, with the SASS of each loop; K5i's four source broadcasts at
     the script's T=512, S=4096, REPS=2048, on its inputs (NaN where r2 < 0)
     and with the third target row made positive, after each one's pair
     loop (SASS a pair); whether the four are bit-equal to each other and
     the pairs with 0 < r2 < FLT_MIN are recorded. Each against its plain
     version, twice bit-equal; its wall time printed.
 15. force hooks, adaptive dt and diagnostics: at N=65536 a hooked World
     ("cuda": force_acc, the hook and the integration in PyTorch, one
     launch a substep, no host sync) against the hooked "torch" World, a
     zero hook against the fused path, and update_adaptive on "cuda"
     against "torch" from the same state (equal substep counts, launches
     exact, no host sync inside a batch); hooked against unhooked and
     adaptive against fixed-dt ms/substep, with profiler windows of the
     adaptive loop and of the hooked and unhooked p3m substep (device
     busy, idle share, p3m stages); at the N=1M p3m slice a hooked
     update (K4 and force_acc counts exact, no host sync) and a hooked
     update_adaptive; summary() on the card against a CPU copy,
     potential_energy_pm against potential_energy, potential_energy_pm
     timed at N=1M; and D=4 shards on one card, "cuda_ring" (the hop
     kernel without its epilogue) and "cuda", hooked against the hooked
     World and adaptive with the World's count. The kernels line gets a
     row for each path's kernel.
 16. collision merging and the CLI: the contact kernel of the merge pass
     (csrc/merge_contacts.cu) against its plain version, bit for bit
     (is_loser, winner and the whole pass), on the N=65536 scene after 10
     substeps of dt 0.01 and on a dense synthetic cluster with equal-mass
     ties, a chain and dead rows; its time, bound and the plain pass's
     time, and its time at the N=1M scene; a merging World at N=65536 on
     "cuda" (10 substeps twice from one state: merges, mass conserved, gm
     = g*mass, bit-equal, exactly 10 contact and 10 fused launches, no
     host sync) timed against the World unmerged; the same gates for D=4
     "cuda_ring" shards on one card; "p3m" merging at the N=1M slice; an
     adaptive merging World on "cuda" and "torch"; then the CLI as a
     user runs it (python -m nbody_tpu_torch run --merge --traj --save,
     render, a resume that keeps merge_collisions, gif to .npz), with the
     files and shapes checked.
 17. differentiable rollouts (nbody_tpu_torch.autodiff): the VJP kernels
     against their plain versions, each cotangent within 2e-5 of max|ref|
     and twice bit-equal, rsqrt and precise: K1's (csrc/direct_vjp.cu) at
     N=1000 (S=333, S=0, zero-radius tracers on gm = 0 sources), the
     N=65536 scene and the N=1M exact-core shape (64 x 524704); K4's
     (csrc/p3m_pp_vjp.cu) on random 8x8 cells, the N=65536 default cells
     and the N=1M slice's cells (on the 8x8 cells around the fullest);
     each kernel's time and bound; K4's batch loop's SASS and MUFU (3 a
     pair in rsqrt), and at both scenes its launches a call, device split,
     range length R, tasks, scratch and longest task against K4's form.
     Then the "cuda" rollout at N=65536,
     precise, 10 steps, remat: the value and gradient of trajectory_loss
     with respect to pos0, vel0, mass, radius and dt (equal to
     World.update with a zero hook, bit-equal twice, exactly 20 force_acc
     and 20 VJP kernel launches, no host sync; ms a step and peak memory);
     "cuda" against "torch" gradients at N=8192 (euler, leapfrog,
     yoshida4; 1e-4; pos0 and vel0 over one leapfrog step also without
     the tracer's row); the
     "p3m" rollout at the N=1M slice and at N=65536 with the default
     config, 2 steps (against World.update, the gradient bit-equal twice,
     exact K4, K4-VJP, force_acc and K1-VJP counts, no host sync);
     rollout_sharded "cuda" with D=4 shards on one card against the
     single-device rollout (1e-5 value, 3e-5 gradient): the tracer's loss
     at N=65536, 3 steps, and over one step without the tracer's row (the
     ring's backward alone), and sum(pos²) on one galaxy of 500
     (nbody_tpu's own case). Two more kernels-line rows.
18. the sharded mesh solvers on one card (no NVLink: D shards share it):
     "auto" by the per-chip rule and AUTO_P3M_MIN_PAIRS (shards on one
     card are one chip; N=262144 at D=4 resolves to "p3m"), the per-chip
     pairs logged; ShardedWorld "p3m" and "pm" with D=4 at the N=1M slice
     (grid 2048, cap 768) and "p3m" at N=65536 with the default config,
     3 substeps of 0.01 against the World on the same config, on four
     seeds, each reading logged, bounds set from them; two runs bit-equal;
     D=1 bit-equal to the World, "p3m" and "pm"; the main path timed with
     exactly D K4 launches and one force_acc launch a shard that holds
     sources, each substep, no host sync; each shard's K4 launch (the
     global-rank cut) against its plain version (at the slice the shard
     the cut drops the most rows from), rows past the cut exactly 0; a
     profiler window split by the p3m stages and the shard sums; the
     sharded "p3m" and "pm" in turns with the World's "p3m"; then
     rollout_sharded "p3m" D=4 at N=65536, 2 steps: against World.update
     (1e-6), the tracer's loss and gradient against the single-device
     rollout (1e-5, 3e-5), exact K4 and K4-VJP launches, no host sync,
     the gradient bit-equal twice. Two more kernels-line rows.
19. the device-side scenes (nbody_tpu_torch.models): make_galaxies_device
     at N=1M (two galaxies) and the Plummer, Kepler and cold disks at
     N=65536, each drawn on the card twice from seed 11037 with host syncs
     turned into errors, bit-equal, checked for structure (counts, fp32,
     mass_len, core and body radii, mass/r³ constants, the tracer rule,
     orbital speeds), wall time (utils.profiling.StepTimer) and device
     time beside the host numpy generator; K1 with every row a source (the
     Plummer World on "cuda", S = N = 65536) against its plain version,
     10 substeps with exactly 10 launches and no host sync, pairs/s and
     bound; tests/test_disks.py's checks on "cuda" (Kepler orbits, the
     cold disk's momentum and infall, its adaptive run through force_acc),
     each gated at that test's size and read at N=65536; the native AVX
     oracle (utils.cpp_oracle, built from cpp/ into build/cpp/) against
     World "cuda", precise: the N=65536 two-galaxy scene after one
     substep (acc, vel, pos within 5e-6 of max), the Plummer disk at
     N=8192 after 10 (rtol 5e-4, atol 5e-2); the N=1M device galaxies on
     "p3m" at the slice's config (K4, rsqrt, and the exact-core
     force_acc against their plain versions, 3 substeps with exact
     launches and no host sync, the cell overflow and the error against
     the direct kernel as readings, a profiler window by stage); then
     python -m nbody_tpu_torch run --scene plummer|kepler|cold at
     N=65536 on "cuda". One more kernels-line row.
20. multi-process on the card (nbody_tpu_torch.parallel.multihost): an
     NCCL group of world size 1 (multihost.initialize; the machine has one
     card, and NCCL refuses two ranks on one device) with D=4 local shards
     on it, through multihost_world at N=65536 "cuda_ring" and at the N=1M
     p3m slice (grid 2048, cap 768): 10 substeps each with the launches
     counted from 0 (K3 D² = 16 a substep, K4 4 a substep and force_acc one
     a shard that holds sources), bit-equal to the single-process
     ShardedWorld on the same mesh, gather_particles equal to particles,
     then update_adaptive with the same count and the same bits; K3 and K4
     against their plain versions at the path's shapes; ms a substep,
     device and host, in turns with the single-process world. Two more
     kernels-line rows. The cross-process transport itself is held on the
     CPU (2 Gloo processes, tests/test_torch_multihost.py).
21. the viewer's ControlState (nbody_tpu_torch.viewer) on a card World at
     N=65536 on "cuda": a fixed frame-time sequence, the fused substep
     launches equal to the substeps the accumulator rule gives, the state
     bit-equal to World.update with the same substeps, no host sync; a
     paused sequence launches nothing; one TAB frame runs on "torch" (no
     launch, bit-equal). Neither matplotlib nor pygame is imported (the
     card machine has neither).
22. shard-native checkpoints (utils.checkpoint on
     torch.distributed.checkpoint): (a) N=1M, two galaxies, seed 11037,
     D=4 shards on the card, "cuda_ring": 2 substeps, save_world_dcp,
     load_sharded_world_dcp onto the same mesh (every shard on its device,
     the state bit-equal), 2 more substeps on both worlds bit-equal with
     exact hop launches; profiler windows around the save and the load
     (memcpy bytes by kind from the trace: no device-to-device copy beyond
     the gm prefix, under 4 KiB to the host during the load; the state's
     n_pad x 32 bytes printed beside them); a D=8 mesh refused with the
     "padded size" ValueError; save and load seconds in turns with the
     npz route (save_world, load_world into a ShardedWorld); (b) the same
     round trip over an NCCL group of one through multihost_world,
     bit-equal; (c) the eight examples (nbody_tpu_torch.examples) through
     runpy, each with its rc, wall seconds and its kernel's launches,
     pm_million at N=1048576 on p3m, the cuts from their defaults logged.
23. physics at horizon on the card (nbody_tpu_torch.scripts), each item
     with its wall seconds, its device ms a substep (CUDA events) and its
     kernels' launches counted from 0: (a) the reference binary's 10k-step
     state (tests/test_physics_validation.py:309): the bit-exact IC
     (N=2000, two galaxies, seed 11037), 10,000 precise substeps of 0.01
     on "cuda" and on "torch", against both committed 10k goldens with the
     4x-self-noise rule, mass bit-exact; (b) that file's single-device 10k
     cases at their scenes, configs and bounds: "torch" and "cuda" (drift
     < 1e-3, |dp|/scale < 1e-6), "pm" at grid 128 (5e-3, 2e-4), leapfrog
     and yoshida4 (1e-3), the default math against the native oracle at
     N=150; (c) its ring case: "cuda_ring" with D=8 shards on the card,
     N=1024 (1e-3, 1e-6); (d) validate_physics at docs/BENCHMARKS.md's
     five rows (N=16384 x 10000 "cuda"; 65536 x 2000 on "cuda", "p3m" and
     "pm"; 262144 x 400 "cuda") and leapfrog and yoshida4 at 65536 x 2000
     on "cuda", each finite with its drift under 1e-3 (exact) or 5e-3
     (mesh); (e) scale_ceiling at its defaults (N=32M, "pm", grid 2048):
     scene and world seconds, ms a substep, peak GiB; (f) verify_drive;
     (g) the compile cache: direct_forces built cold into a fresh
     directory (nvcc seconds), then a CLI subprocess with --compile-cache
     on that directory loads it with no build (the directory unchanged),
     and cache_entries counts it. The kernels line gets one row: K1's
     fused substep over (b)'s 10k "cuda" run.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import socket
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
RING_SRC = "nbody_tpu_torch/csrc/ring_forces.cu"
# Sharded runs: the race check's shard counts, the main path's (N, D) and
# its timed substeps per backend ("torch" is the plain version).
RACE_SHARDS = (2, 3, 4, 8)
SHARDED = ((BENCH_N, 1), (BENCH_N, 4), (BIG_N, 4))
SHARDED_SUBSTEPS = {BENCH_N: {"cuda_ring": 20, "cuda": 20, "torch": 2},
                    BIG_N: {"cuda_ring": 3, "cuda": 3, "torch": 1}}
# The D=4 sharded world against the single-device World after 10 substeps
# of dt 0.01, on eight seeds. One evaluation on the same state differs by
# the order of the fp32 sums only (per-hop sums against one sum; measured
# 4.7e-7 of max|a| on an H100, held to BOUND_SMALL), but close pairs
# amplify that rounding from substep to substep, by an amount that depends
# on the scene. Measured on an H100 over the eight seeds, as max|d|/max:
# pos 1.2e-8 to 1.7e-7, vel 5.1e-6 to 3.9e-4, acc 1.1e-5 to 2.7e-3; the
# plain World (another order of the same sums on one device) against the
# kernel's World: pos up to 2.5e-7, vel up to 2.8e-4, acc up to 2.3e-3.
# The bounds are 5x the largest sharded reading, rounded up to one digit;
# and the largest sharded gap over the seeds may be at most SHARD_VS_PLAIN
# times the plain World's largest (measured 0.68x pos, 1.4x vel, 1.2x acc).
SHARD_VS_WORLD = {"pos": 1e-6, "vel": 2e-3, "acc": 2e-2}
SHARD_VS_PLAIN = 3.0
SHARD_VS_WORLD_SEEDS = (SEED, 1, 2, 3, 4, 5, 6, 7)
# Substeps of the profiler window over the D > 1 cuda_ring worlds.
PROFILE_SUBSTEPS = {BENCH_N: 5, BIG_N: 2}
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
# cores and HBM bandwidth; and the special-function (MUFU) rate, 16 per SM
# per clock on sm_90, times the SM count and the maximum SM clock that
# phase [0] reads from the card. The bound of a function is the largest of
# its fp32 operations, its MUFU operations and its bytes over these.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MUFU_PER_SM_CLOCK = 16
MUFU_RATE = None                # set by phase_env: MUFU ops per second
# Operations per pair: the direct sum as the TPU kernel counts it
# (pallas_forces.py:380), the P3M correction as p3m_pallas.py:120-125 does;
# MUFU operations per pair: one rsqrt (the default path), two rsqrt and a
# sqrt per live P3M pair. A Newton dual pair shares dx, dy and d2 (5
# operations) between two interactions of 8 more each, and has two rsqrt.
FLOPS_DIRECT = 13
FLOPS_PP = 14
FLOPS_DUAL = 21
MUFU_DIRECT = 1
MUFU_PP = 3
# The ablation path ([13]): the kernels' sources, the TPU kernels they
# replace, and a ragged N for K5h (mass_len 24807: neither it nor N is a
# whole number of tiles).
ABLATION_KERNELS = {
    "K5a": ("nbody_tpu_torch/csrc/v2_forces.cu",
            "scripts/ablations/tune_r2.py:40"),
    "K5g": ("nbody_tpu_torch/csrc/ptile_forces.cu",
            "scripts/ablations/tune_r2g.py:34"),
    "K5d": ("nbody_tpu_torch/csrc/stationary_forces.cu",
            "scripts/ablations/tune_r2d.py:37"),
    "K5h": ("nbody_tpu_torch/csrc/newton_forces.cu",
            "scripts/ablations/tune_r2h.py:49"),
    "K5b-cols": ("nbody_tpu_torch/csrc/v2_forces.cu",
                 "scripts/ablations/tune_r2b.py:48"),
    "K5b-rows": ("nbody_tpu_torch/csrc/v2_forces.cu",
                 "scripts/ablations/tune_r2b.py:85"),
    "K5c": ("nbody_tpu_torch/csrc/v2_forces.cu",
            "scripts/ablations/tune_r2c.py:35"),
    "K5e": ("nbody_tpu_torch/csrc/flavor_forces.cu",
            "scripts/ablations/tune_r2e.py:40"),
    "K5f": ("nbody_tpu_torch/csrc/op_probe.cu",
            "scripts/ablations/tune_r2f.py:25"),
    "K5i": ("nbody_tpu_torch/csrc/bcast_probe.cu",
            "scripts/ablations/tune_r4d_bcast_probe.py:23"),
}
RAGGED_N = 50000
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
# [15] hooks and adaptive dt. The hooked and adaptive runs start from the
# scene and run HOOK_SUBSTEPS of HOOK_DT, as [11]'s D=4-against-World
# check does; the adaptive span is ADAPTIVE_SUBSTEPS times the criterion's
# dt at the start (P3M_ADAPTIVE_SUBSTEPS at the N=1M p3m slice). A hooked
# or adaptive World on "cuda" integrates outside the kernel, so against
# the plain "torch" World, and a zero hook against the fused path, it
# differs by the order of the force sums and by FMA contraction, amplified
# by close pairs from substep to substep: the comparison that
# SHARD_VS_WORLD's bounds were set for from readings ([11]).
HOOK_DT = 0.01
HOOK_SUBSTEPS = 10
ADAPTIVE_SUBSTEPS = 30
P3M_ADAPTIVE_SUBSTEPS = 4
HOOK_VS_PLAIN = SHARD_VS_WORLD
# potential_energy_pm against potential_energy (tests/test_diagnostics.py)
PE_PM_BOUND = 0.02
# summary() on the card against the same on a CPU copy of the state
SUMMARY_BOUND = 1e-5
TIMED_SUBSTEPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def check(what: str, err: float, bound: float) -> None:
    ok = np.isfinite(err) and err < bound
    log(f"  {what}: max|d|/max|ref| = {err:.3e} (bound {bound:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {what} out of bound")


def log_plans(label: str, plans) -> None:
    """Print the plans that the launches counted in ``plans`` (a wrapper's
    {Plan: launches}) took, then clear it."""
    for plan, k in sorted(plans.items()):
        log(f"  {label}: {k} launch(es) with {plan.describe()}")
    plans.clear()


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
    from nbody_tpu_torch.ablations._scene import sm_clock_mhz

    global MUFU_RATE
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    MUFU_RATE = MUFU_PER_SM_CLOCK * sms * mhz * 1e6
    log(f"{sms} SMs, max SM clock {mhz:g} MHz: MUFU peak {MUFU_RATE:.4e} ops/s")
    # The plain versions use no matmul or convolution, but pin full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def bound(flops: float, nbytes: float, mufu: float = 0.0) -> tuple[float, str]:
    """(ms, what sets it): the least time the card could take for this
    many fp32 operations, MUFU operations and bytes moved. "operations"
    when the fp32 or the MUFU term is the longer one, else "bytes"."""
    t_ops = max(flops / PEAK_FP32, mufu / MUFU_RATE)
    t_bytes = nbytes / PEAK_BYTES
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
                if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                        or "spill" in line):
                    log(f"    {line.strip()}")


def pair_loops(_build, sass) -> None:
    """The pair loop of the main-path kernels on the rsqrt path (the direct
    kernel's fused form): SASS instructions a pair (the largest innermost
    loop over its MUFU.RSQ, one a pair), registers and spill bytes from
    the build's ``-Xptxas -v`` lines, for each P."""
    for lib, kernel, tail in (("direct_forces", "direct_forces_kernel", "Lb1E"),
                              ("ring_forces", "ring_hop_kernel", "")):
        path = _build.library_path(lib)
        funcs = sass.functions(path)
        usage = sass.ptxas_usage(path.with_suffix(".log").read_text())
        for p in (1, 2):
            name = sass.find(funcs, rf"{kernel}ILi{p}ELb0E{tail}")
            n, mufu = sass.pair_loop(funcs[name], "MUFU")
            u = usage[name]
            if not mufu:
                raise SystemExit(f"chip_smoke: no pair loop found in {name}")
            log(f"  {lib} P={p}: pair loop {n} SASS instructions for {mufu} "
                f"pairs, {n / mufu:.2f} a pair; {u['registers']} registers, "
                f"spill {u['spill_stores']} bytes stored, {u['spill_loads']} "
                f"loaded")


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


# Forced plans on a small ragged shape (T=1000 against S=333, two runs):
# each P with a cluster of 2, and with a cluster of 8 whose last 6 ranges
# are empty.
FORCED_PLANS = ((1, 2), (2, 2), (1, 8), (2, 8))


def forced_clusters(df, device) -> None:
    """[2]: force_acc and fused_substep with the FORCED_PLANS against the
    plain version, so that the cluster path is held to it at every P even
    where the main path would not split."""
    pos, vel, radius, gm = random_state(1000, 333, device)
    src = pos[:333]
    for p, n_split in FORCED_PLANS:
        plan = df.Plan(p, n_split)
        for precise in (False, True):
            tag = f"T=1000 S=333 {plan.describe()} {'precise' if precise else 'rsqrt'}"
            want = df.force_acc_plain(pos, radius, src, gm, precise=precise)
            check(f"{tag} force_acc", rel(df.force_acc(
                pos, radius, src, gm, precise=precise, plan=plan), want),
                BOUND_SMALL)
            npos, nvel, acc = df.fused_substep(0.01, pos, vel, radius, gm,
                                               precise=precise, plan=plan)
            check(f"{tag} fused_substep acc", rel(acc, want), BOUND_SMALL)
            check(f"{tag} fused_substep vel (epilogue)",
                  rel(nvel, vel + 0.01 * acc), BOUND_EPILOGUE)
            check(f"{tag} fused_substep pos (epilogue)",
                  rel(npos, pos + df._pos_dt_times_dt(1.0, 0.01) * nvel),
                  BOUND_EPILOGUE)
    log_plans("forced", df.PLANS)


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


def pair_counts(cells, rc, cap: int) -> dict:
    """What K4's cells route must do on these runs: live target and source
    rows, candidate pairs (each live target against the live sources of
    its 9 neighbour cells), pairs inside rc (d² < rc² in fp32, without the
    kernel's FMA, so a pair on the boundary may count otherwise), and the
    kernel's tasks (tiles of up to 32 live targets of a cell); and the
    warp iterations of K4's form (a warp a tile against each row of its
    cell's 3×3 neighbourhood), whose lanes the candidates fill."""
    trows, srows, st, ct, ss, cs = cells
    n_t, n_s, g = trows.shape[0], srows.shape[0], ct.numel()
    gc = math.isqrt(g)
    ct_live, cs_live = ct.clamp(max=cap).long(), cs.clamp(max=cap).long()
    cell = torch.repeat_interleave(torch.arange(g, device=ct.device), ct.long())
    rank = torch.arange(n_t, device=ct.device) - st.long()[cell]
    rows = torch.nonzero(rank < cap).reshape(-1)
    cell = cell[rows]
    ci, cj = cell // gc, cell % gc
    rc = torch.as_tensor(rc, dtype=torch.float32, device=ct.device)
    rc2 = rc * rc
    k = torch.arange(cap, device=ct.device)
    chunk = max(1, (1 << 24) // cap)
    candidates = inside = 0
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ni, nj = ci + di, cj + dj
            ok = (ni >= 0) & (ni < gc) & (nj >= 0) & (nj < gc)
            nc = torch.where(ok, ni * gc + nj, 0)
            ns = torch.where(ok, cs_live[nc], 0)
            candidates += int(ns.sum())
            for r0 in range(0, rows.shape[0], chunk):
                r = slice(r0, r0 + chunk)
                sidx = (ss.long()[nc[r]][:, None] + k).clamp(max=max(n_s - 1, 0))
                dx = srows[sidx, 0] - trows[rows[r], 0][:, None]
                dy = srows[sidx, 1] - trows[rows[r], 1][:, None]
                near = (dx * dx + dy * dy < rc2) & (k < ns[r, None])
                inside += int(near.sum())
    from nbody_tpu_torch.ablations.tune_pp_vjp import task_rows

    return {"live_t": int(ct_live.sum()), "live_s": int(cs_live.sum()),
            "n_t": n_t, "cells": g, "cap": cap, "candidates": candidates,
            "inside": inside, "tasks": int(((ct_live + 31) // 32).sum()),
            "warp_iterations": task_rows(ct, cs, gc, cap, cap,
                                         1)["warp_iterations"],
            "cells_with_targets": int((ct_live > 0).sum())}


def pp_bound(c: dict) -> tuple[float, str]:
    """K4's bound on the cells route: 5 operations (dx, dy, d², the
    compare) for every candidate pair, 14 more and 3 MUFU for every pair
    inside rc; the live rows (16 bytes each) and the four run arrays read
    once, one (x, y) written per target row."""
    nbytes = 16 * (c["live_t"] + c["live_s"]) + 16 * c["cells"] + 8 * c["n_t"]
    return bound(5 * c["candidates"] + FLOPS_PP * c["inside"], nbytes,
                 MUFU_PP * c["inside"])


def pp_blocks_bound(c: dict) -> tuple[float, str]:
    """The bound of pp_blocks with counts, as PR 3 counted it: 14
    operations and 3 MUFU per candidate pair, the live (x, y, r|gm) slots
    and both counts read once, the dense (gc², cap_t, 2) output written."""
    nbytes = 12 * (c["live_t"] + c["live_s"]) + 8 * c["cells"] \
        + 8 * c["cells"] * c["cap"]
    return bound(FLOPS_PP * c["candidates"], nbytes,
                 MUFU_PP * c["candidates"])


def cells_and_blocks(pp, trows, t_radius, srows, counts_t, counts_s, cap):
    """The cells route's inputs (rows, each cell's start and count) and the
    (gc, gc, cap) blocks that nbody_tpu's pp_blocks takes on the same
    cells: tx, ty, tr (the radius without the softening floor, 1 in an
    empty slot), sx, sy, sg (0 in an empty slot)."""
    gc = math.isqrt(counts_t.numel())
    starts = [torch.cumsum(c, 0, dtype=torch.int32) - c
              for c in (counts_t, counts_s)]
    cells = [trows, srows, starts[0], counts_t, starts[1], counts_s]
    blocks = []
    for vals, start, counts, fills in (
            ([trows[:, 0], trows[:, 1], t_radius], starts[0], counts_t,
             (0.0, 0.0, 1.0)),
            ([srows[:, 0], srows[:, 1], srows[:, 2]], starts[1], counts_s,
             (0.0, 0.0, 0.0))):
        idx, live = pp.run_slots(start, counts, cap, vals[0].shape[0])
        idx = idx.clamp(max=vals[0].shape[0] - 1)
        blocks += [torch.where(live, v[idx], f).reshape(gc, gc, cap)
                   .contiguous() for v, f in zip(vals, fills)]
    return cells, blocks


def world_bins(pp, p3m_forces, world) -> tuple:
    """The bins and the cell-sorted target and source rows that
    world.update(backend="p3m") builds for K4 on the world's current
    state, and rc."""
    cfg, st, s = world.config, world.state, world.mass_len
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], world.gm,
                               grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                               exact_targets=0)
    trows = p3m_forces._cell_rows(st.pos, st.radius + pp.SOFTENING_FLOOR,
                                  bins["order_t"])
    srows = p3m_forces._cell_rows(st.pos[:s], world.gm, bins["order_s"])
    return bins, trows, srows, cfg.p3m_rc_cells * bins["h"]


def world_cells(pp, p3m_forces, world):
    """The rows, runs and rc that world.update(backend="p3m") hands K4 on
    the world's current state, and the blocks of the same cells."""
    bins, trows, srows, rc = world_bins(pp, p3m_forces, world)
    cells, blocks = cells_and_blocks(
        pp, trows, world.state.radius[bins["order_t"]], srows,
        bins["counts_t"], bins["counts_s"], world.config.p3m_cell_capacity)
    for mine, theirs in zip(cells[2::2], (bins["start_t"], bins["start_s"])):
        if not torch.equal(mine, theirs):
            raise SystemExit("chip_smoke: p3m_bins' run starts are not the "
                             "exclusive prefix sums of its counts")
    return cells, blocks, rc


def random_cells(pp, device, gc: int = 8, cap: int = 32):
    """Random cells of size 4 (rc = 4) in cell order: 0 to cap + 8 targets
    and sources a cell (some cells empty, some past the cap), positions
    inside their own cell, random radii and gm."""
    rng = np.random.default_rng(0)
    counts = [rng.integers(0, cap + 9, gc * gc).astype(np.int32)
              for _ in range(2)]
    counts[0][:2] = (0, cap)        # an empty cell and a full one
    rows = []
    for c, w_lo, w_hi in ((counts[0], 0.5, 9.5), (counts[1], 10.0, 1e4)):
        cell = np.repeat(np.arange(gc * gc), c)
        xy = (np.stack([cell // gc, cell % gc], 1)
              + rng.uniform(size=(len(cell), 2))) * 4.0
        w = rng.uniform(w_lo, w_hi, len(cell))
        rows.append(np.concatenate([xy, w[:, None], np.zeros((len(cell), 1))],
                                   1).astype(np.float32))
    radius = torch.from_numpy(rows[0][:, 2].copy()).to(device)
    rows[0][:, 2] += np.float32(pp.SOFTENING_FLOOR)
    trows, srows = (torch.from_numpy(r).to(device) for r in rows)
    cells, blocks = cells_and_blocks(pp, trows, radius, srows,
                                     *(torch.from_numpy(c).to(device)
                                       for c in counts), cap)
    return cells, blocks, 4.0


def compare_pp(pp, label, cells, blocks, rc, cap: int, dense_plain: bool) -> dict:
    """K4 on the cells route against pp_cells_plain, rsqrt and precise;
    pp_blocks on the same cells against the plain version with the counts
    (and its rows bit for bit against the cells route's) and with every
    slot (held to the plain version on every slot with ``dense_plain``,
    else on the live slots). Returns the cells route's largest max|d| and
    its timings."""
    trows = cells[0]
    n_t = trows.shape[0]
    idx, live = pp.run_slots(cells[2], cells[3], cap, n_t)
    idx = idx.clamp(max=n_t - 1)
    kw_c = {"cap_t": cap, "cap_s": cap}
    kw_b = {"counts_t": cells[3], "counts_s": cells[5]}
    worst, bits = 0.0, {}
    for precise in (False, True):
        tag = "precise" if precise else "rsqrt"
        t0 = time.perf_counter()
        want = pp.pp_cells_plain(*cells, rc, 4.0, precise=precise, **kw_c)
        torch.cuda.synchronize()
        if not precise:
            plain_ms = (time.perf_counter() - t0) * 1e3
        got = pp.pp_cells(*cells, rc, 4.0, precise=precise, **kw_c)
        check(f"{label} {tag} cells route", rel(got, want), BOUND_PP)
        worst = max(worst, float((got - want).abs().max()))
        want_b = torch.where(live[..., None], want[idx], 0.0)
        got_b = pp.pp_blocks(*blocks, rc, 4.0, precise=precise, **kw_b)
        check(f"{label} {tag} pp_blocks with counts", rel(got_b, want_b),
              BOUND_PP)
        bits[tag] = torch.equal(got_b[live], got[idx[live]])
        got_a = pp.pp_blocks(*blocks, rc, 4.0, precise=precise)
        if not torch.isfinite(got_a).all():
            raise SystemExit(f"chip_smoke: {label} {tag} all slots not finite")
        if dense_plain:
            check(f"{label} {tag} pp_blocks all slots", rel(
                got_a, pp.pp_blocks_plain(*blocks, rc, 4.0, precise=precise)),
                BOUND_PP)
        else:
            check(f"{label} {tag} pp_blocks all slots, on the live slots",
                  rel(got_a[live], want_b[live]), BOUND_PP)
        del want, want_b, got_b, got_a
    log(f"  {label}: the cells route's live rows bit-equal to pp_blocks': "
        f"rsqrt {bits['rsqrt']}, precise {bits['precise']}")
    c = pair_counts(cells, rc, cap)
    ms = cuda_ms(lambda: pp.pp_cells(*cells, rc, 4.0, **kw_c), reps=20)
    ms_b = cuda_ms(lambda: pp.pp_blocks(*blocks, rc, 4.0, **kw_b), reps=5)
    ms_all = cuda_ms(lambda: pp.pp_blocks(*blocks, rc, 4.0), reps=3)
    bound_ms, bound_by = pp_bound(c)
    bb_ms, bb_by = pp_blocks_bound(c)
    log(f"  {label}: {c['cells_with_targets']} of {c['cells']} cells hold "
        f"targets; {c['live_t']} live targets, {c['live_s']} live sources; "
        f"candidate pairs {c['candidates']:.4e}, inside rc {c['inside']:.4e} "
        f"({c['inside'] / max(c['candidates'], 1):.1%}); {c['tasks']} tasks, "
        f"lanes busy {c['live_t'] / max(32 * c['tasks'], 1):.1%} by tasks, "
        f"{c['candidates'] / max(32 * c['warp_iterations'], 1):.1%} by work "
        f"({c['warp_iterations']:.4e} warp iterations)")
    log(f"  {label}: cells route {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {bound_ms / ms:.1%} of it); plain {plain_ms:.3f} ms; "
        f"pp_blocks {ms_b:.4f} ms with counts (bound {bb_ms:.4f} ms, "
        f"{bb_by}), {ms_all:.4f} ms all slots")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bits": bits,
            "counts": c, "blocks_ms": ms_b, "all_ms": ms_all}


def phase_pp(pp, p3m_forces, slice_w, default_w, device) -> dict:
    log("[6] K4 (P3M pair correction) against its plain version on the card")
    out = {}
    cells, blocks, rc = random_cells(pp, device)
    compare_pp(pp, "random 8x8 cells cap 32", cells, blocks, rc, 32, True)
    for key, world, dense in (("sized", slice_w, False),
                              ("default", default_w, True)):
        cfg = world.config
        cells, blocks, rc = world_cells(pp, p3m_forces, world)
        out[key] = compare_pp(
            pp, f"N={world.total_len} grid {cfg.pm_grid} gc="
            f"{cfg.pm_grid // cfg.p3m_rc_cells} cap={cfg.p3m_cell_capacity}",
            cells, blocks, rc, cfg.p3m_cell_capacity, dense)
        out[key]["n"] = world.total_len
        del cells, blocks
    return out


def phase_split(df, p3m_forces, slice_w, device) -> dict:
    log("[7] source-split force_acc against its plain version on the card")
    st, s = slice_w.state, slice_w.mass_len
    rows = p3m_forces.exact_core_rows(st.radius, slice_w.config.p3m_exact_targets)
    tp, tr = st.pos[rows].contiguous(), st.radius[rows].contiguous()
    src, gm = st.pos[:s], slice_w.gm
    t = tp.shape[0]
    plan = df.cluster_plan(t, s, df.device_sms(device))
    worst = 0.0
    df.PLANS.clear()
    for precise in (False, True):
        got = df.force_acc(tp, tr, src, gm, precise=precise)
        want = df.force_acc_plain(tp, tr, src, gm, precise=precise)
        check(f"exact-core rows T={t} S={s} ({plan.describe()}) "
              f"{'precise' if precise else 'rsqrt'}", rel(got, want),
              BOUND_SPLIT_BIG)
        worst = max(worst, float((got - want).abs().max()))
    ms = cuda_ms(lambda: df.force_acc(tp, tr, src, gm), reps=20)
    plain_ms = cuda_ms(lambda: df.force_acc_plain(tp, tr, src, gm), reps=3)
    acc = torch.empty_like(tp)
    single_ms = cuda_ms(lambda: df._launch(tp, None, tr, src, gm, 0.0, 1.0,
                                           False, acc, None, None,
                                           plan=df.Plan(1, 1)), reps=3)
    bound_ms, bound_by = bound(FLOPS_DIRECT * t * s, 20 * t + 12 * s,
                               MUFU_DIRECT * t * s)
    log(f"  exact-core rows: split kernel {ms:.4f} ms, one-block form "
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
    log_plans("[7]", df.PLANS)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "single_ms": single_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "t": t, "s": s}


PROFILE_TRIES = 3


def profile_window(fn, measure):
    """fn() in a torch.profiler window, with CUDA events around it; the
    window's events go to ``measure``, which returns None where they lack
    the device time it reads. The profiler on an H100 has dropped a whole
    window's device events, so a window that measure refuses is run again,
    up to PROFILE_TRIES windows. Returns measure's result (None if every
    window was refused), fn's result, and the last window's wall ms and
    CUDA-event ms."""
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        got = measure(prof.events())
        if got is not None:
            return got, out, wall_ms, start.elapsed_time(end)
        log(f"  profiler window {attempt} of {PROFILE_TRIES} held too little "
            "device time")
    return None, out, wall_ms, start.elapsed_time(end)


def not_profiled(what: str, event_ms: float) -> float:
    """Log that the profiler measured nothing of ``what`` in PROFILE_TRIES
    windows and the CUDA-event time instead; NaN for the numbers it lacks."""
    log(f"  NOT MEASURED: the profiler saw no device time for {what} in "
        f"{PROFILE_TRIES} windows; CUDA events {event_ms:.4f} ms instead, "
        "and the profiler's numbers below are nan")
    return float("nan")


def profile_stages(world, n: int = 3, dt: float = 1.0,
                   extra_force=None, stages=STAGES) -> dict:
    """Device and host ms per substep of each of ``stages``, the device
    busy time and the idle share of a torch.profiler window over n "p3m"
    substeps of dt (with the hook ``extra_force`` where given; a sharded
    world runs its own backend).
    A stage's device time is that of the kernels, copies and fills that run
    inside the span its record_function range has on the device timeline;
    its host time is the range's own. (The kernels launched through ctypes
    are on the device timeline but linked to no host-side op, so the host
    ranges' device totals would miss them.)"""
    from torch.autograd import DeviceType

    def measure(events):
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        spans = [(e.name, e.time_range.start, e.time_range.end)
                 for e in dev if e.name in stages]
        work = [(e.time_range.start, e.time_range.end)
                for e in dev if e.name not in stages]
        busy_ms = sum(b - a for a, b in work) / 1e3
        per_stage = {name: sum(b - a for a, b in work
                               if any(nm == name and lo <= a and b <= hi
                                      for nm, lo, hi in spans)) / n / 1e3
                     for name in stages}
        host = {name: sum(e.cpu_time_total for e in events
                          if e.device_type == DeviceType.CPU and e.name == name)
                / n / 1e3 for name in stages}
        if busy_ms <= 0 or per_stage["p3m.pair_kernel"] <= 0:
            return None
        return per_stage, host, busy_ms

    world.block_until_ready()
    # a World takes the backend, a ShardedWorld runs its own
    kw = {} if hasattr(world, "n_devices") else {"backend": "p3m"}
    got, _, wall_ms, event_ms = profile_window(
        lambda: world.update(dt, n, extra_force=extra_force, **kw), measure)
    if got is None:
        nan = not_profiled("the p3m stages", event_ms / n)
        return {"stages": dict.fromkeys(stages, nan),
                "host": dict.fromkeys(stages, nan), "busy_ms": nan,
                "wall_ms": wall_ms / n, "idle": nan}
    per_stage, host, busy_ms = got
    return {"stages": per_stage, "host": host, "busy_ms": busy_ms / n,
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


def row_gather(pp, p3m_forces, world) -> None:
    """p3m.pack's gather of the targets into cell order (each 16-byte row
    one complex128 element) timed against the same gather of rows of four
    fp32; the two must give the same bits."""
    cfg, st = world.config, world.state
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:world.mass_len],
                               world.gm, grid=cfg.pm_grid,
                               rc_cells=cfg.p3m_rc_cells, exact_targets=0)
    w, order = st.radius + pp.SOFTENING_FLOOR, bins["order_t"]

    def fp32_rows():
        return torch.cat([st.pos, w[:, None], torch.zeros_like(w)[:, None]],
                         1)[order]

    same = torch.equal(p3m_forces._cell_rows(st.pos, w, order), fp32_rows())
    ms = cuda_ms(lambda: p3m_forces._cell_rows(st.pos, w, order), reps=20)
    ms_fp32 = cuda_ms(fp32_rows, reps=20)
    log(f"  p3m.pack's target gather, {len(order)} rows of 16 bytes: "
        f"{ms:.4f} ms as complex128 elements, {ms_fp32:.4f} ms as rows of "
        f"four fp32; bit-equal {same}")
    if not same:
        raise SystemExit("chip_smoke: the row gather changed the rows' bits")


def phase_p3m(nt, df, pp, p3m_forces, scene_big, scene_bench, device,
              direct_big_ms) -> dict:
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
    row_gather(pp, p3m_forces, world)
    small = nt.create_world(scene_bench, config=nt.SimConfig(**P3M_DEFAULT),
                            device=device)
    out["bench"] = run_p3m(df, pp, small, f"N={BENCH_N} default config (time only)")
    return out


def mesh_repeat(nt, pm, scene, device) -> dict:
    """A "pm" World (grid 2048) and a "p3m" World (the slice config) at
    N=1M, each run 3 substeps twice from the same state: the states must
    be bit-equal. Then the CIC scatter on the slice world's sources, run
    twice and timed, against the index_add_ form it replaced (float
    atomics on the card)."""
    for backend, cfg in (("pm", {"pm_grid": 2048}), ("p3m", P3M_SIZED)):
        runs = []
        for _ in range(2):
            w = nt.create_world(scene, config=nt.SimConfig(**cfg), device=device)
            w.update(1.0, 3, backend=backend)
            runs.append(w.particles)
        same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
                   for f in ("pos", "vel", "acc"))
        finite = all(torch.isfinite(getattr(runs[0], f)).all()
                     for f in ("pos", "vel", "acc"))
        log(f"  {backend} World {cfg}, N={len(w)}, 3 substeps, run twice: "
            f"bit-equal {same}, finite {finite}")
        if not (same and finite):
            raise SystemExit(f"chip_smoke: two {backend} runs differ or are "
                             "not finite")
    st, s = w.state, w.mass_len
    grid = P3M_SIZED["pm_grid"]
    src, gm = st.pos[:s], w.gm
    lo, h = pm._box(*pm._bounds(st.pos, src, gm), grid)

    def sorted_scatter():
        return pm._cic_scatter(src, gm, lo, 1.0 / h, grid)

    def atomic_scatter():
        i0, j0, wx, wy = pm._cic_weights(src, lo, 1.0 / h, grid)
        rho = torch.zeros(grid * grid, dtype=torch.float32, device=device)
        c = i0 * grid + j0
        for dc, wt in ((0, (1 - wx) * (1 - wy)), (grid, wx * (1 - wy)),
                       (1, (1 - wx) * wy), (grid + 1, wx * wy)):
            rho.index_add_(0, c + dc, gm * wt)
        return rho.reshape(grid, grid)

    out = {}
    for name, fn in (("index_put_ (sorted)", sorted_scatter),
                     ("index_add_ (atomics)", atomic_scatter)):
        a, b = fn(), fn()
        out[name] = {"same": bool(torch.equal(a, b)),
                     "ms": cuda_ms(fn, reps=20)}
        log(f"  CIC scatter by {name}, {s} sources on grid {grid}: "
            f"{out[name]['ms']:.4f} ms, two runs bit-equal {out[name]['same']}")
    log(f"  sorted against atomic scatter: max|d|/max = "
        f"{rel(sorted_scatter(), atomic_scatter()):.3e}")
    if not out["index_put_ (sorted)"]["same"]:
        raise SystemExit("chip_smoke: the sorted CIC scatter differs from run to run")
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


def phase_ring_hop(rf, df, device) -> None:
    log("[10] K3 (ring hop) against its plain version on the card")
    pos, vel, radius, gm = random_state(1000, 400, device)
    valid = (torch.arange(1000, device=device) < 990).to(torch.float32)
    # a running sum from an earlier hop, so the hop adds into it
    run0 = df.force_acc_plain(pos, radius, pos[:50], gm[:50])
    for n_src in (333, 0):
        for precise in (False, True):
            tag = f"S={n_src} of a 400-row slot, {'precise' if precise else 'rsqrt'}"
            run_k, run_p = run0.clone(), run0.clone()
            kw = dict(accumulate=True, precise=precise)
            rf.ring_hop(pos, radius, pos[:400], gm[:n_src], run_k, **kw)
            rf.ring_hop_plain(pos, radius, pos[:400], gm[:n_src], run_p, **kw)
            check(f"{tag} middle hop running sum", rel(run_k, run_p), BOUND_SMALL)
            for pos_dt in (1.0, 0.5):
                run = run0.clone()
                last = dict(vel=vel, valid=valid, dt=0.01, pos_dt=pos_dt, **kw)
                npos, nvel, acc = rf.ring_hop(pos, radius, pos[:400], gm[:n_src],
                                              run, **last)
                want = rf.ring_hop_plain(pos, radius, pos[:400], gm[:n_src],
                                         run0.clone(), **last)[2]
                what = f"{tag} last hop pos_dt={pos_dt}"
                check(f"{what} acc", rel(acc, want), BOUND_SMALL)
                if not (torch.equal(acc[990:], torch.zeros_like(acc[990:]))
                        and torch.equal(run, run0)):
                    raise SystemExit(f"chip_smoke: {what}: padding rows not "
                                     "masked or the running sum changed")
                check(f"{what} vel (epilogue)", rel(nvel, vel + 0.01 * acc),
                      BOUND_EPILOGUE)
                check(f"{what} pos (epilogue)",
                      rel(npos, pos + df._pos_dt_times_dt(pos_dt, 0.01) * nvel),
                      BOUND_EPILOGUE)
    log_plans("[10]", rf.PLANS)
    # each P with a forced cluster split (FORCED_PLANS), T=1000 S=333
    for p, n_split in FORCED_PLANS:
        plan = df.Plan(p, n_split)
        for precise in (False, True):
            tag = f"S=333 {plan.describe()} {'precise' if precise else 'rsqrt'}"
            kw = dict(accumulate=True, precise=precise)
            run_k, run_p = run0.clone(), run0.clone()
            rf.ring_hop(pos, radius, pos[:400], gm[:333], run_k, plan=plan, **kw)
            rf.ring_hop_plain(pos, radius, pos[:400], gm[:333], run_p, **kw)
            check(f"{tag} middle hop running sum", rel(run_k, run_p), BOUND_SMALL)
            last = dict(vel=vel, valid=valid, dt=0.01, pos_dt=1.0, **kw)
            npos, nvel, acc = rf.ring_hop(pos, radius, pos[:400], gm[:333],
                                          run0.clone(), plan=plan, **last)
            want = rf.ring_hop_plain(pos, radius, pos[:400], gm[:333],
                                     run0.clone(), **last)[2]
            check(f"{tag} last hop acc", rel(acc, want), BOUND_SMALL)
            check(f"{tag} last hop vel (epilogue)", rel(nvel, vel + 0.01 * acc),
                  BOUND_EPILOGUE)
            check(f"{tag} last hop pos (epilogue)",
                  rel(npos, pos + df._pos_dt_times_dt(1.0, 0.01) * nvel),
                  BOUND_EPILOGUE)
    log_plans("[10] forced", rf.PLANS)


def sharded(sh, scene, d: int, device, backend: str = "cuda_ring", **cfg):
    return sh.ShardedWorld(scene, sh.make_mesh(devices=[device] * d),
                           config=sh.SimConfig(**cfg), force_backend=backend)


def phase_race(nt, sh, rf, df, galaxy_ref, load_hex_dump, scene_bench,
               device) -> None:
    log(f"[11] race check: the sharded backends on one card, N={BENCH_N}, "
        "overlapped streams against a run synchronised after every hop and copy")
    for backend, counter in (("cuda_ring", rf), ("cuda", df)):
        for d in RACE_SHARDS:
            runs = []
            for serial in (False, True):
                w = sharded(sh, scene_bench, d, device, backend)
                w.ring.serial = serial
                counter.LAUNCHES = 0
                w.update(1.0, 5)
                if counter.LAUNCHES != 5 * d * d:
                    raise SystemExit(f"chip_smoke: {backend} D={d}: "
                                     f"{counter.LAUNCHES} launches, expected "
                                     f"{5 * d * d}")
                runs.append(w.particles)
            same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
                       for f in ("pos", "vel", "acc"))
            finite = all(torch.isfinite(getattr(runs[0], f)).all()
                         for f in ("pos", "vel", "acc"))
            log(f"  {backend} D={d} (t_loc {w.t_loc}, s_loc {w.s_loc}, real "
                f"sources {w.ring.n_real}): {counter.LAUNCHES} launches, "
                f"bit-equal to the serial run: {same}, finite: {finite}")
            if not (same and finite):
                raise SystemExit(f"chip_smoke: {backend} D={d}: the overlapped "
                                 "ring differs from the serial one (a race) or "
                                 "is not finite")
    ref = nt.create_world(scene_bench, device=device)
    ref.update(0.01, 10)
    one = sharded(sh, scene_bench, 1, device)
    one.update(0.01, 10)
    same = all(torch.equal(getattr(one.particles, f), getattr(ref.particles, f))
               for f in ("pos", "vel", "acc"))
    log(f"  D=1 after 10 substeps bit-equal to World 'cuda' (the same sums): {same}")
    if not same:
        raise SystemExit("chip_smoke: D=1 differs from the World's kernel")
    # every seed's gap is logged before any is checked
    gaps, plain_gaps = {}, {}
    for seed in SHARD_VS_WORLD_SEEDS:
        scene = scene_bench if seed == SEED else nt.make_galaxies(BENCH_N, 2,
                                                                  seed=seed)
        world = ref if seed == SEED else nt.create_world(scene, device=device)
        if seed != SEED:
            world.update(0.01, 10)
        w = sharded(sh, scene, 4, device)
        w.update(0.01, 10)
        gaps[seed] = {f: rel(getattr(w.particles, f), getattr(world.particles, f))
                      for f in SHARD_VS_WORLD}
        plain = nt.create_world(scene, device=device)
        plain.update(0.01, 10, backend="torch")
        plain_gaps[seed] = {f: rel(getattr(plain.particles, f),
                                   getattr(world.particles, f))
                            for f in SHARD_VS_WORLD}
        log(f"  seed {seed}: D=4 against World 'cuda' after 10 substeps, "
            + ", ".join(f"{f} {e:.3e}" for f, e in gaps[seed].items())
            + "; World 'torch' against World 'cuda', "
            + ", ".join(f"{f} {e:.3e}" for f, e in plain_gaps[seed].items()))
    for f, b in SHARD_VS_WORLD.items():
        most = max(g[f] for g in gaps.values())
        check(f"D=4 against World 'cuda' after 10 substeps, {f}, largest of "
              f"{len(gaps)} seeds", most, b)
        plain_most = max(g[f] for g in plain_gaps.values())
        ratio = most / plain_most if plain_most else (np.inf if most else 0.0)
        ok = ratio < SHARD_VS_PLAIN
        log(f"  {f}: largest sharded gap / largest World 'torch' gap "
            f"({plain_most:.3e}) = {ratio:.3f} (bound {SHARD_VS_PLAIN:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the D=4 world's {f} drifts from "
                             "World more than another order of the sums does")
    st = ref.state
    again = sharded(sh, sh.Particles(st.pos, st.vel, st.acc, st.mass, st.radius),
                    4, device)
    again.update(0.01, 1)
    check("D=4 one evaluation on the World's state, acc",
          rel(again.particles.acc,
              df.force_acc(st.pos, st.radius, st.pos[:ref.mass_len],
                           ref.gm).cpu()),
          BOUND_SMALL)
    ic = galaxy_ref.make_galaxies_libc(2000, 2, seed=SEED)
    perm, _ = nt.partition_massive_first(ic.mass)
    steps, pos_bound, vel_bound = GOLDEN_BOUNDS[0]
    golden = load_hex_dump(ROOT / GOLDEN.format(steps=steps))[perm.numpy()]
    w = sharded(sh, ic, 4, device, precise=True)
    w.update(0.01, steps)
    got = w.particles
    dpos = float(np.abs(got.pos.numpy() - golden[:, :2]).max()
                 / np.abs(golden[:, :2]).max())
    dvel = float(np.abs(got.vel.numpy() - golden[:, 2:4]).max()
                 / np.abs(golden[:, 2:4]).max())
    check(f"golden through cuda_ring D=4, {steps} steps rel pos", dpos, pos_bound)
    check(f"golden through cuda_ring D=4, {steps} steps rel vel", dvel, vel_bound)


def time_sharded(world, n: int, counter, per_substep: int) -> dict:
    """After a warm-up substep: a checked run of n substeps with host syncs
    turned into errors and the launch count from 0, which must be exactly
    per_substep * n; then device and host ms per substep of a timed run of
    n substeps without the debug mode (it adds host time to every
    operation, and this path is bound by the host)."""
    world.update(1.0, 1)
    world.block_until_ready()
    counter.LAUNCHES = 0
    counter.PLANS.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        world.update(1.0, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = counter.LAUNCHES
    plans = dict(counter.PLANS)
    if launches != per_substep * n:
        raise SystemExit(f"chip_smoke: {launches} launches over {n} "
                         f"substeps, expected {per_substep * n}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    world.update(1.0, n)
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {"ms": start.elapsed_time(end) / n, "enqueue_ms": enqueue_ms / n,
            "launches": launches, "plans": plans}


def visiting(world) -> tuple:
    """The real sources of shard 1 (of shard 0 when D = 1), positions and
    gm, as they visit shard 0 at a hop of the world's ring."""
    k = min(1, world.n_devices - 1)
    n = world.ring.n_real[k]
    src = torch.cat(world.pos)[k * world.s_loc:k * world.s_loc + n]
    return src, world.ring.gm_src[k][:n]


def last_hop(rf, world):
    """A call of K3 at the world's last hop: shard 0's targets against the
    sources of :func:`visiting`, with the epilogue."""
    src, gm = visiting(world)
    pos, vel, radius, valid = (x[0] for x in (world.pos, world.vel,
                                              world.radius, world.valid))
    return lambda: rf.ring_hop(pos, radius, src, gm, torch.empty_like(pos),
                               vel=vel, valid=valid,
                               t_real=world.ring.t_real[0], accumulate=False,
                               dt=1.0, pos_dt=1.0)


def hop_error(rf, world, rows=None) -> float:
    """max|kernel - plain| of the last hop at the world's shapes: shard 0's
    targets against the sources of :func:`visiting`, with the epilogue;
    with ``rows`` the plain version computes only those targets."""
    src, gm = visiting(world)
    n = gm.shape[0]
    pos, vel, radius, valid = (x[0] for x in (world.pos, world.vel,
                                              world.radius, world.valid))
    kw = dict(accumulate=False, dt=1.0, pos_dt=1.0)
    acc = last_hop(rf, world)()[2]
    log_plans("hop kernel vs plain", rf.PLANS)
    label = "" if rows is None else f" ({len(rows)} targets)"
    rows = torch.arange(pos.shape[0], device=pos.device) if rows is None else rows
    want = rf.ring_hop_plain(pos[rows], radius[rows], src, gm,
                             torch.empty_like(pos[rows]), vel=vel[rows],
                             valid=valid[rows], **kw)[2]
    bound_ = BOUND_BIG if pos.shape[0] > BENCH_N else BOUND_SMALL
    check(f"hop kernel vs plain at T={pos.shape[0]} S={n}{label}",
          rel(acc[rows], want), bound_)
    return float((acc[rows] - want).abs().max())


def union_ms(spans) -> float:
    """Total length in ms of the union of (start, end) µs intervals."""
    spans = sorted(spans)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def profile_overlap(world, n: int, kernel: str, launch_ms=None,
                    launches: int = 0) -> dict:
    """Device time of a torch.profiler window over n substeps of a sharded
    world, per substep: the kernels' and copies' summed time, the time the
    card had at least one of them running (the union of their intervals;
    the shards' streams overlap), the idle share of the wall time; and the
    summed and the union time of the kernels whose name holds ``kernel``.
    Where no window sees ``kernel``, ``launch_ms()`` (one launch timed with
    CUDA events) times ``launches`` a substep, summed, in its place."""
    from torch.autograd import DeviceType

    def measure(events):
        events = [e for e in events if e.device_type == DeviceType.CUDA]
        mine = [(e.time_range.start, e.time_range.end) for e in events
                if kernel in e.name]
        if not mine:
            return None
        return [(e.time_range.start, e.time_range.end) for e in events], mine

    world.block_until_ready()
    got, _, wall_ms, event_ms = profile_window(lambda: world.update(1.0, n),
                                               measure)
    if got is None:
        nan = not_profiled(kernel, event_ms / n)
        if launch_ms is None:
            raise SystemExit(f"chip_smoke: no time for {kernel}")
        one = launch_ms()
        log(f"  {kernel}: {one:.4f} ms a launch (CUDA events, alone), "
            f"{launches} a substep, summed")
        return {"sum_ms": nan, "busy_ms": nan, "wall_ms": wall_ms / n,
                "idle": nan, "kernel_launches": launches,
                "kernel_sum_ms": one * launches,
                "kernel_busy_ms": one * launches}
    spans, mine = got
    busy = union_ms(spans)
    return {"sum_ms": sum(b - a for a, b in spans) / 1e3 / n,
            "busy_ms": busy / n, "wall_ms": wall_ms / n,
            "idle": 1.0 - busy / wall_ms,
            "kernel_launches": len(mine) / n,
            "kernel_sum_ms": sum(b - a for a, b in mine) / 1e3 / n,
            "kernel_busy_ms": union_ms(mine) / n}


def force_acc_error(df, world, rows=None) -> float:
    """max|kernel - plain| of the "cuda" backend's hop at the world's
    shapes: force_acc on shard 0's targets against the sources of
    :func:`visiting`; with ``rows`` the plain version computes only those
    targets."""
    src, gm = visiting(world)
    n = gm.shape[0]
    pos, radius = world.pos[0], world.radius[0]
    t = pos.shape[0]
    plan = df.cluster_plan(t, n, df.device_sms(pos.device))
    acc = df.force_acc(pos, radius, src, gm)
    label = "" if rows is None else f" ({len(rows)} targets)"
    rows = torch.arange(t, device=pos.device) if rows is None else rows
    want = df.force_acc_plain(pos[rows], radius[rows], src, gm)
    check(f"force_acc ('cuda' backend) vs plain at T={t} S={n}, "
          f"{plan.describe()}{label}", rel(acc[rows], want),
          BOUND_BIG if t > BENCH_N else BOUND_SMALL)
    return float((acc[rows] - want).abs().max())


def finite_state(world, what: str) -> None:
    p = world.particles
    if not all(torch.isfinite(x).all() for x in (p.pos, p.vel, p.acc)):
        raise SystemExit(f"chip_smoke: non-finite state, {what}")


def phase_sharded(sh, rf, df, scene_bench, scene_big, device) -> dict:
    log("[12] sharded main path on one card (no NVLink: D shards share it)")
    out = {}
    for n, d in SHARDED:
        scene = scene_bench if n == BENCH_N else scene_big
        steps = SHARDED_SUBSTEPS[n]
        res = {}
        w = sharded(sh, scene, d, device)
        w.update(1.0, 2)
        res["cuda_ring"] = time_sharded(w, steps["cuda_ring"], rf, d * d)
        finite_state(w, f"cuda_ring N={n} D={d}")
        if d > 1:
            k = PROFILE_SUBSTEPS[n]
            prof = profile_overlap(
                w, k, "ring_hop_kernel", launches=d * d,
                launch_ms=lambda: cuda_ms(last_hop(rf, w), reps=10))
            log(f"  N={n} D={d} cuda_ring profiler over {k} substeps, per "
                f"substep: kernels and copies {prof['sum_ms']:.4f} ms summed, "
                f"card busy {prof['busy_ms']:.4f} ms of {prof['wall_ms']:.4f} ms "
                f"wall (idle {prof['idle']:.2%}); ring_hop_kernel "
                f"{prof['kernel_launches']:g} launches, {prof['kernel_sum_ms']:.4f} "
                f"ms summed, {prof['kernel_busy_ms']:.4f} ms union")
            res["profile"] = prof
        rows = None
        if n == BIG_N:
            rows = torch.from_numpy(np.random.default_rng(4).choice(
                w.t_loc, SUBSET, replace=False)).to(device)
        res["max_abs_err"] = hop_error(rf, w, rows)
        res["layout"] = (w.t_loc, w.s_loc, list(w.ring.n_real))
        res["mass_len"] = w.mass_len
        res["n_pad"] = w.n_pad
        del w
        w = sharded(sh, scene, d, device, backend="cuda")
        res["cuda"] = time_sharded(w, steps["cuda"], df, d * d)
        finite_state(w, f"cuda N={n} D={d}")
        res["cuda"]["max_abs_err"] = force_acc_error(df, w, rows)
        del w
        w = sharded(sh, scene, d, device, backend="torch")
        w.block_until_ready()
        res["torch"] = {"ms": cuda_ms(lambda: w.update(1.0, steps["torch"]))
                        / steps["torch"]}
        del w
        pairs = n * res["mass_len"]
        for backend in ("cuda_ring", "cuda", "torch"):
            r = res[backend]
            extra = (f", host {r['enqueue_ms']:.4f} ms/substep to enqueue, "
                     f"launches {r['launches']}" if "launches" in r else "")
            log(f"  N={n} D={d} {backend:9s}: {r['ms']:.4f} ms/substep device, "
                f"{pairs / (r['ms'] * 1e-3):.4e} pairs/s{extra}")
            for plan, k in sorted(r.get("plans", {}).items()):
                log(f"    {k} launch(es) with {plan.describe()}")
        log(f"  N={n} D={d}: t_loc {res['layout'][0]}, s_loc {res['layout'][1]}, "
            f"real sources per shard {res['layout'][2]}")
        out[(n, d)] = res
    return out


def phase_ablations(nt, df, device) -> dict:
    """[13]: each ablation module's sweep at N=65536 with the four launch
    counts from 0, then K5h at RAGGED_N against the direct sum; the best
    configuration of each kernel, its plain version's time and its bound."""
    from nbody_tpu_torch.ablations import _scene, tune_r2, tune_r2d, tune_r2g, tune_r2h
    from nbody_tpu_torch.ops import newton_forces as nwf
    from nbody_tpu_torch.ops import ptile_forces as ptf
    from nbody_tpu_torch.ops import resident_forces as rsf
    from nbody_tpu_torch.ops import stationary_forces as stf

    log(f"[13] the ablation path of the direct force: N={BENCH_N}, 2 galaxies, "
        f"seed {SEED}")
    scene = _scene.make_scene(BENCH_N, device=device)
    k1_ms = _scene.header("scene", scene, log)
    counters = {"K5a": rsf, "K5g": ptf, "K5d": stf, "K5h": nwf}
    runs = {"K5a": tune_r2, "K5g": tune_r2g, "K5d": tune_r2d, "K5h": tune_r2h}
    for c in counters.values():
        c.LAUNCHES = 0
    results = {}
    for key, module in runs.items():
        log(f" {key}: nbody_tpu_torch.ablations.{module.__name__.rsplit('.', 1)[1]}")
        results[key] = module.run(scene, k1_ms, log)
    launches = {key: c.LAUNCHES for key, c in counters.items()}
    log(f"  launches over the four sweeps: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"chip_smoke: a kernel of the ablation path was not "
                         f"launched: {launches}")
    log(f"  K5h at a ragged N={RAGGED_N}:")
    tune_r2h.check_direct(_scene.make_scene(RAGGED_N, device=device), log)

    n, m, s128 = scene.n, scene.mass_len, scene.s128
    tgt3, tgt4 = scene.tgt3(), scene.tgt4()
    out = {}
    for key, res in results.items():
        best = min(res, key=lambda r: r["ms"])
        cfg = best["config"]
        if key == "K5a":
            src = scene.src3(s128)
            plain = lambda: rsf.v2_acc_plain(scene.pos, scene.radius, src)  # noqa: E731
        elif key == "K5g":
            src = scene.src3(s128)
            plain = lambda: ptf.ptile_acc_plain(tgt3, src)  # noqa: E731
        elif key == "K5d":
            s_pad, chunk = cfg["s_pad"], cfg["chunk"]
            src = scene.src3(s_pad)
            plain = lambda: stf.stationary_acc_plain(tgt3, src, chunk=chunk)  # noqa: E731
        else:
            src, tile = scene.src4(s128), cfg["tile"]
            plain = lambda: nwf.newton_acc_plain(tgt4, src, m, tile=tile)  # noqa: E731
        # The bound counts the N x mass_len pairs that the function needs,
        # not the gm = 0 rows that pad the sources of a kernel's layout.
        if key == "K5h":
            fwd, dual = cfg["forward_pairs"], cfg["dual_pairs"]
            b = bound(FLOPS_DIRECT * fwd + FLOPS_DUAL * dual,
                      24 * n + 16 * m, MUFU_DIRECT * (fwd + 2 * dual))
        else:
            b = bound(FLOPS_DIRECT * n * m, 20 * n + 12 * m,
                      MUFU_DIRECT * n * m)
        plain()
        plain_ms = cuda_ms(plain)
        out[key] = {"best": best, "plain_ms": plain_ms, "bound_ms": b[0],
                    "bound_by": b[1], "launches": launches[key]}
        log(f"  {key} best {best['name']}: {best['ms']:.4f} ms "
            f"({best['ms'] / k1_ms:.3f}x force_acc {k1_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
            f"{b[0] / best['ms']:.1%} of the bound")
        if key == "K5g":
            log_sweep_row("K5g", best)
        if key == "K5h":
            p, sa = best["plan"], best["sass"]
            log(f"    K5h plan: {p['tasks']} tasks ({p['massive']} massive) "
                f"of {p['group']} items, {p['blocks_per_sm']} blocks and "
                f"{p['warps_per_sm']} warps an SM, {p['waves']:.1f} waves; "
                f"SASS a dual pair {sa.get('dual', float('nan')):.2f}, a "
                f"forward pair {sa.get('forward', float('nan')):.2f}; "
                f"{sa['registers']} registers, {sa['spill_stores']} spill "
                f"bytes")
    out["k1_ms"] = k1_ms
    return out


def log_sweep_row(key: str, best: dict) -> None:
    """The stage, SASS a pair, registers and spills of K5g's or K5e's best
    configuration (``pair_step.cuh``'s chunked sweep)."""
    c, sa = best["config"], best["sass"]
    log(f"    {key} stage {c['stage']} sources a chunk of {c['chunk']}; SASS "
        f"a pair {sa['sass_per_pair']:.2f} at P={c['p']} ({sa['loop']} for "
        f"{sa['pairs']} pairs); {sa['registers']} registers, "
        f"{sa['spill_stores']} spill bytes stored, {sa['spill_loads']} loaded")


def phase_probes(device, _build, sass) -> dict:
    """[14]: K5b, K5e and K5c at N=65536, K5f and K5i at their scripts'
    shapes, with the four launch counts from 0; for each kernel line, the
    best configuration (K5c at full, K5f at rsqrt), its plain version's
    time and its bound. First K5b's pair loop per flavor and P, and K5i's
    per variant."""
    from nbody_tpu_torch.ablations import (_scene, tune_r2b, tune_r2c, tune_r2e,
                                           tune_r2f, tune_r4d_bcast_probe)
    from nbody_tpu_torch.ops import bcast_probe as bp
    from nbody_tpu_torch.ops import flavor_forces as ff
    from nbody_tpu_torch.ops import op_probe as op
    from nbody_tpu_torch.ops import v2_forces as v2

    t0 = time.perf_counter()
    log(f"[14] the rest of the ablation path: N={BENCH_N}, 2 galaxies, seed "
        f"{SEED}; the op and broadcast probes at their scripts' shapes")
    scene = _scene.make_scene(BENCH_N, device=device)
    k1_ms = _scene.header("scene", scene, log)
    n, m, s128 = scene.n, scene.mass_len, scene.s128
    lib = _build.library_path("v2_forces")
    tune_r2b.pair_loops(sass.functions(lib), sass.ptxas_usage(
        lib.with_suffix(".log").read_text()), log)
    k5i_sass = tune_r4d_bcast_probe.pair_loops(_build.library_path("bcast_probe"),
                                               log)
    v2.LAUNCHES = ff.LAUNCHES = op.LAUNCHES = bp.LAUNCHES = 0
    log(" K5b: nbody_tpu_torch.ablations.tune_r2b (csrc/v2_forces.cu)")
    k5b = tune_r2b.run(scene, k1_ms, log)
    k5b_launches = v2.LAUNCHES
    log(" K5e: nbody_tpu_torch.ablations.tune_r2e")
    k5e = tune_r2e.run(scene, k1_ms, log)
    log(" K5c: nbody_tpu_torch.ablations.tune_r2c (csrc/v2_forces.cu)")
    k5c = tune_r2c.run(scene, k1_ms, log)
    k5c_launches = v2.LAUNCHES - k5b_launches
    log(" K5f: nbody_tpu_torch.ablations.tune_r2f")
    k5f = tune_r2f.run(device, log)
    log(" K5i: nbody_tpu_torch.ablations.tune_r4d_bcast_probe")
    k5i = tune_r4d_bcast_probe.run(device, log)
    launches = {"v2_forces K5b": k5b_launches, "v2_forces K5c": k5c_launches,
                "flavor_forces K5e": ff.LAUNCHES, "op_probe": op.LAUNCHES,
                "bcast_probe": bp.LAUNCHES}
    log(f"  launches over the five sweeps: {launches}")
    if not all(launches.values()):
        raise SystemExit(f"chip_smoke: a kernel of [14] was not launched: "
                         f"{launches}")

    out = {}
    direct = bound(FLOPS_DIRECT * n * m, 20 * n + 12 * m, MUFU_DIRECT * n * m)
    tgt, src = scene.tgt3(), scene.src3(s128)

    def plain_ms(fn) -> float:
        fn()
        return cuda_ms(fn)

    def record(key, best, plain, b, count, label=None):
        out[key] = {"best": best, "plain_ms": plain, "bound_ms": b[0],
                    "bound_by": b[1], "launches": count, "label": label}
        log(f"  {key} {best['name']}: {best['ms']:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
            f"{b[0] / best['ms']:.1%} of the bound, launches {count}")

    for layout, rows in (("cols", False), ("rows", True)):
        mine = [r for r in k5b if r["config"]["rows"] == rows]
        best = min(mine, key=lambda r: r["ms"])
        c = best["config"]
        tg = tgt if rows else (scene.pos, scene.radius)
        record(f"K5b-{layout}", best, plain_ms(lambda: v2.v2_acc_plain(
            tg, src, flavor=c["flavor"], chunk=c["chunk"])),
            direct, sum(r["launches"] for r in mine))
    best = min(k5e, key=lambda r: r["ms"])
    c = best["config"]
    record("K5e", best, plain_ms(lambda: ff.flavor_acc_plain(
        tgt, src, flavor=c["flavor"], p=c["p"], chunk=c["chunk"])),
        direct, launches["flavor_forces K5e"])
    log_sweep_row("K5e", best)
    # The pairs each probe's function needs (tune_r2c.pairs): N x mass_len
    # where its terms carry gm, N x S128 where the gm = 0 padding rows
    # count too.
    for r in k5c:
        flops, mufu = tune_r2c.OPS[r["name"]]
        pairs = r["config"]["pairs"]
        r["bound"] = bound(flops * pairs, 20 * n + 12 * s128, mufu * pairs)
        log(f"  K5c {r['name']:>9}: bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.1%} of it")
    full = next(r for r in k5c if r["name"] == "full")
    record("K5c", full, plain_ms(lambda: v2.v2_acc_plain(
        tgt, src, flavor="full", chunk=tune_r2c.CHUNK)), full["bound"],
        k5c_launches)
    elems = tune_r2f.TT * tune_r2f.CC
    iters = tune_r2f.HI - tune_r2f.LO
    for r in k5f:
        flops, mufu = tune_r2f.OPS[r["name"]]
        r["bound"] = bound(flops * elems * iters, 12 * elems,
                           mufu * elems * iters)
        log(f"  K5f {r['name']:>9}: bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.1%} of it")
    rsqrt = next(r for r in k5f if r["name"] == "rsqrt")
    x, y = tune_r2f.inputs("rsqrt", device)
    lo_ms, hi_ms = (plain_ms(lambda loops=loops: op.op_probe_plain(
        x, y, expr="rsqrt", loops=loops)) for loops in (tune_r2f.LO, tune_r2f.HI))
    record("K5f", rsqrt, hi_ms - lo_ms, rsqrt["bound"], launches["op_probe"],
           label=f"K5f rsqrt, ({tune_r2f.TT}, {tune_r2f.CC}) elements, "
                 f"{iters} iterations (the marginal time from "
                 f"{tune_r2f.LO} to {tune_r2f.HI} loops)")
    mine = [r for r in k5i if r["inputs"] == "script"]
    best = min(mine, key=lambda r: r["ms"])
    same = all(r["equal_to_first"] for r in mine)
    log(f"  K5i: the four variants bit-equal to each other on the script's "
        f"inputs: {same}; pairs with 0 < r2 < FLT_MIN: "
        f"{mine[0]['subnormal_pairs']}; SASS a pair "
        + ", ".join(f"{v} {x:.2f}" for v, x in k5i_sass.items()))
    t_i, s_i = tune_r4d_bcast_probe.inputs(device)
    pairs = tune_r4d_bcast_probe.T * tune_r4d_bcast_probe.S * tune_r4d_bcast_probe.REPS
    record("K5i", best, plain_ms(lambda: bp.bcast_acc_plain(
        t_i, s_i, reps=tune_r4d_bcast_probe.REPS, n_split=best["n_split"])),
        bound(FLOPS_DIRECT * pairs, 20 * tune_r4d_bcast_probe.T
              + 12 * tune_r4d_bcast_probe.S, MUFU_DIRECT * pairs),
        launches["bcast_probe"],
        label=f"K5i {best['name']}, T={tune_r4d_bcast_probe.T} "
              f"S={tune_r4d_bcast_probe.S} REPS={tune_r4d_bcast_probe.REPS} "
              f"(fastest of the four broadcasts)")
    out["K5i"].update(variants_equal=same, sass_a_pair=k5i_sass)
    log(f"  [14] took {time.perf_counter() - t0:.1f} s")
    return out


def drag(pos, vel):
    """The hook of [15]: linear drag, written with operators only."""
    return -0.1 * vel


def zero_hook(pos, vel):
    return 0.0 * vel


@contextlib.contextmanager
def no_sync(world_mod=None):
    """Host syncs turned into errors while the block runs; with
    ``world_mod`` (nbody_tpu_torch.world) the adaptive loops' own reads of
    their flag and count (``world._host``) are let through."""
    orig = None if world_mod is None else world_mod._host
    if orig is not None:
        def lifted(x):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return orig(x)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        world_mod._host = lifted
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        if orig is not None:
            world_mod._host = orig


def expect_launches(what: str, got, want) -> None:
    if got != want:
        raise SystemExit(f"chip_smoke: {what}: expected {want} launches, "
                         f"got {got}")


def check_gaps(label: str, got, want, bounds: dict) -> dict:
    """max|d|/max of pos, vel and acc of two worlds' particles, each
    checked against ``bounds``; the state must be finite."""
    a, b = got.particles, want.particles
    if not all(torch.isfinite(x).all() for x in (a.pos, a.vel, a.acc)):
        raise SystemExit(f"chip_smoke: non-finite state, {label}")
    gaps = {}
    for name, limit in bounds.items():
        gaps[name] = rel(getattr(a, name), getattr(b, name))
        check(f"{label}: {name}", gaps[name], limit)
    return gaps


def adaptive_evaluations(k: int, stages: int = 1) -> int:
    """Force evaluations of an adaptive call of k substeps: the priming
    substep, then whole batches up to the one that reaches the span."""
    from nbody_tpu_torch.world import ADAPTIVE_BATCH

    return stages * (1 + ADAPTIVE_BATCH * -(-k // ADAPTIVE_BATCH))


def timed(fn) -> tuple[float, float, object]:
    """(device ms from CUDA events, host ms, fn's result) of one call."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3, out


def hooked_vs_unhooked(world, n: int, backend: str) -> dict:
    """ms per substep of n unhooked and n hooked substeps of HOOK_DT, in
    turns (unhooked, hooked, hooked, unhooked): the mean device and host
    times of each kind, and every run's device time under "runs"."""
    runs = {"unhooked": [], "hooked": []}
    for kind in ("unhooked", "hooked", "hooked", "unhooked"):
        hook = drag if kind == "hooked" else None
        dev, host, _ = timed(lambda: world.update(HOOK_DT, n, backend=backend,
                                                  extra_force=hook))
        runs[kind].append((dev / n, host / n))
    out = {kind: (float(np.mean([d for d, _ in v])),
                  float(np.mean([h for _, h in v]))) for kind, v in runs.items()}
    out["runs"] = {kind: [d for d, _ in v] for kind, v in runs.items()}
    return out


def profile_call(fn) -> dict:
    """A torch.profiler window over one call of fn: the call's result, the
    device busy time (the union of its kernels', copies' and fills'
    intervals), the wall time and the idle share, in ms."""
    from torch.autograd import DeviceType

    def measure(events):
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA]
        return union_ms(spans) if spans else None

    busy, out, wall_ms, event_ms = profile_window(fn, measure)
    if busy is None:
        busy = not_profiled("the call", event_ms)
    return {"out": out, "busy_ms": busy, "wall_ms": wall_ms,
            "idle": 1.0 - busy / wall_ms}


def phase_hooks(nt, sh, df, rf, pp, world_mod, diagnostics, scene_bench,
                scene_big, device) -> dict:
    """[15]: force hooks, adaptive dt and diagnostics on the card."""
    log(f"[15] hooks and adaptive dt: N={BENCH_N} direct, N={BIG_N} p3m "
        f"slice, diagnostics, D=4 sharded on one card")
    out = {}
    # hooked World, N=65536: force_acc + hook + integration a substep
    hooked = nt.create_world(scene_bench, device=device)
    df.LAUNCHES = 0
    df.PLANS.clear()
    with no_sync():
        hooked.update(HOOK_DT, HOOK_SUBSTEPS, extra_force=drag)
    torch.cuda.synchronize()
    out["hook_launches"] = df.LAUNCHES
    expect_launches("hooked World 'cuda'", df.LAUNCHES, HOOK_SUBSTEPS)
    log(f"  hooked World 'cuda', {HOOK_SUBSTEPS} substeps of {HOOK_DT}: "
        f"force_acc launches {df.LAUNCHES}, no host sync")
    log_plans("hooked World", df.PLANS)
    plain = nt.create_world(scene_bench, device=device)
    plain.update(HOOK_DT, HOOK_SUBSTEPS, backend="torch", extra_force=drag)
    out["hook_gaps"] = check_gaps("hooked 'cuda' vs hooked 'torch' World",
                                  hooked, plain, HOOK_VS_PLAIN)
    zero = nt.create_world(scene_bench, device=device)
    fused = nt.create_world(scene_bench, device=device)
    zero.update(HOOK_DT, HOOK_SUBSTEPS, extra_force=zero_hook)
    fused.update(HOOK_DT, HOOK_SUBSTEPS)
    out["zero_gaps"] = check_gaps("zero hook vs unhooked fused World", zero,
                                  fused, HOOK_VS_PLAIN)
    del plain, zero, fused

    # the force_acc of the hooked path at its shapes, against its plain version
    st, gm = hooked.state, hooked.gm
    n, m = st.n, gm.shape[0]
    args = (st.pos, st.radius, st.pos[:m], gm)
    err = rel(df.force_acc(*args), df.force_acc_plain(*args))
    check(f"force_acc vs plain at the hooked World's shapes N={n} S={m}",
          err, BOUND_SMALL)
    b_ms, b_by = bound(FLOPS_DIRECT * n * m, 20 * n + 12 * m, MUFU_DIRECT * n * m)
    out["force_acc"] = {
        "n": n, "s": m, "launches": out["hook_launches"],
        "max_abs_err": float((df.force_acc(*args)
                              - df.force_acc_plain(*args)).abs().max()),
        "ms": cuda_ms(lambda: df.force_acc(*args), reps=20),
        "plain_ms": cuda_ms(lambda: df.force_acc_plain(*args), reps=2),
        "bound_ms": b_ms, "bound_by": b_by}
    t = hooked_vs_unhooked(hooked, TIMED_SUBSTEPS, "cuda")
    out["times_direct"] = t
    log(f"  N={BENCH_N} 'cuda' ms/substep, device (host): unhooked fused "
        f"{t['unhooked'][0]:.4f} ({t['unhooked'][1]:.4f}), hooked "
        f"{t['hooked'][0]:.4f} ({t['hooked'][1]:.4f}), in turns "
        f"{t['runs']}; force_acc alone {out['force_acc']['ms']:.4f}")
    del hooked

    # adaptive World, N=65536: the span sized for ~ADAPTIVE_SUBSTEPS substeps
    probe = nt.create_world(scene_bench, device=device)
    probe.update(0.0, 1)
    dt0 = float(diagnostics.suggest_dt(probe.state))
    span = ADAPTIVE_SUBSTEPS * dt0
    del probe
    a_k = nt.create_world(scene_bench, device=device)
    df.LAUNCHES = 0
    with no_sync(world_mod):
        dev, host, k = timed(lambda: a_k.update_adaptive(span))
    expect_launches(f"adaptive 'cuda' ({k} substeps)", df.LAUNCHES,
                    adaptive_evaluations(k))
    out["adaptive"] = {"k": k, "span": span, "dt0": dt0,
                       "launches": df.LAUNCHES}
    a_p = nt.create_world(scene_bench, device=device)
    k_p = a_p.update_adaptive(span, backend="torch")
    log(f"  adaptive World, span {span:.6g} (criterion dt {dt0:.6g} at the "
        f"start): 'cuda' {k} substeps, {df.LAUNCHES} force_acc launches, no "
        f"host sync inside a batch; 'torch' {k_p} substeps")
    if k != k_p:
        raise SystemExit(f"chip_smoke: adaptive substeps 'cuda' {k} != "
                         f"'torch' {k_p}")
    out["adaptive"]["gaps"] = check_gaps("adaptive 'cuda' vs 'torch' World",
                                         a_k, a_p, HOOK_VS_PLAIN)
    del a_p
    # ms per substep: a second adaptive call against fixed-dt update at its count
    dev, host, k2 = timed(lambda: a_k.update_adaptive(span))
    fixed = nt.create_world(scene_bench, device=device)
    fixed.update(dt0, 1)
    f_dev, f_host, _ = timed(lambda: fixed.update(dt0, k2))
    out["adaptive"]["times"] = {"k": k2, "ms": dev / k2, "host_ms": host / k2,
                                "fixed_ms": f_dev / k2,
                                "fixed_host_ms": f_host / k2}
    log(f"  N={BENCH_N} ms/substep, device (host): adaptive {dev / k2:.4f} "
        f"({host / k2:.4f}) over {k2} substeps ({adaptive_evaluations(k2)} "
        f"force evaluations), fixed-dt fused update {f_dev / k2:.4f} "
        f"({f_host / k2:.4f}) at the same count")
    prof = profile_call(lambda: a_k.update_adaptive(span))
    k3 = prof["out"]
    out["adaptive"]["profile"] = {key: prof[key] / k3 for key in
                                  ("busy_ms", "wall_ms")}
    out["adaptive"]["profile"]["idle"] = prof["idle"]
    log(f"  adaptive profiler window, {k3} substeps: card busy "
        f"{prof['busy_ms'] / k3:.4f} ms a substep of {prof['wall_ms'] / k3:.4f}"
        f" wall (idle {prof['idle']:.2%}, the profiler's host cost included)")
    del a_k, fixed

    # the N=1M p3m slice, hooked and adaptive, from the scene at HOOK_DT
    # (drag at dt 1.0 slows the galaxies into denser cores: a costlier
    # state than [8] times)
    slice_cfg = nt.SimConfig(**P3M_SIZED)
    w = nt.create_world(scene_big, config=slice_cfg, device=device)
    w.update(HOOK_DT, 1, backend="p3m", extra_force=drag)
    df.LAUNCHES = pp.LAUNCHES = 0
    with no_sync():
        w.update(HOOK_DT, P3M_SUBSTEPS, backend="p3m", extra_force=drag)
    torch.cuda.synchronize()
    got = {"force_acc": df.LAUNCHES, "pp": pp.LAUNCHES}
    expect_launches("hooked p3m", got, {"force_acc": P3M_SUBSTEPS,
                                        "pp": P3M_SUBSTEPS})
    finite_state(w, "hooked p3m")
    t = hooked_vs_unhooked(w, P3M_SUBSTEPS, "p3m")
    out["times_p3m"] = t
    log(f"  N={BIG_N} p3m slice, hooked: launches K4 {got['pp']}, force_acc "
        f"{got['force_acc']} in {P3M_SUBSTEPS} substeps, no host sync; "
        f"ms/substep device (host): unhooked {t['unhooked'][0]:.4f} "
        f"({t['unhooked'][1]:.4f}), hooked {t['hooked'][0]:.4f} "
        f"({t['hooked'][1]:.4f}), in turns {t['runs']}")
    for kind, hook in (("unhooked", None), ("hooked", drag)):
        prof = profile_stages(w, 3, dt=HOOK_DT, extra_force=hook)
        out[f"p3m_profile_{kind}"] = prof
        log(f"  {kind} p3m profiler window, 3 substeps of {HOOK_DT}: card "
            f"busy {prof['busy_ms']:.4f} ms a substep of {prof['wall_ms']:.4f}"
            f" wall (idle {prof['idle']:.2%}); device ms by stage " + ", ".join(
                f"{name} {ms:.4f}" for name, ms in prof["stages"].items()))
    p_dt0 = float(diagnostics.suggest_dt(w.state))
    df.LAUNCHES = pp.LAUNCHES = 0
    with no_sync(world_mod):
        dev, host, k = timed(lambda: w.update_adaptive(
            P3M_ADAPTIVE_SUBSTEPS * p_dt0, backend="p3m", extra_force=drag))
    evals = adaptive_evaluations(k)
    expect_launches("adaptive p3m", {"force_acc": df.LAUNCHES,
                                     "pp": pp.LAUNCHES},
                    {"force_acc": evals, "pp": evals})
    finite_state(w, "adaptive p3m")
    out["p3m_adaptive"] = {"k": k, "ms": dev / k, "evaluations": evals}
    log(f"  N={BIG_N} p3m slice, hooked adaptive over {P3M_ADAPTIVE_SUBSTEPS}"
        f" x {p_dt0:.6g}: {k} substeps, {evals} force evaluations (K4 and "
        f"force_acc each), fresh bins at each, {dev / k:.4f} ms/substep "
        f"device ({host / k:.4f} host), finite, no host sync inside a batch")
    del w

    # diagnostics: the card against the plain judge on a CPU copy
    w = nt.create_world(scene_bench, device=device)
    w.update(1.0, 1)
    dev, host, s_k = timed(lambda: diagnostics.summary(w))
    cpu = type("CpuCopy", (), {"state": w.state.to("cpu"),
                               "total_len": w.total_len,
                               "mass_len": w.mass_len})()
    t0 = time.perf_counter()
    s_c = diagnostics.summary(cpu)
    cpu_s = time.perf_counter() - t0
    for key in ("kinetic_energy", "potential_energy", "angular_momentum",
                "suggested_dt"):
        check(f"summary {key}, card vs CPU copy",
              abs(s_k[key] - s_c[key]) / abs(s_c[key]), SUMMARY_BOUND)
    for key in ("momentum", "center_of_mass"):
        got_, want_ = torch.tensor(s_k[key]), torch.tensor(s_c[key])
        check(f"summary {key}, card vs CPU copy", rel(got_, want_),
              SUMMARY_BOUND)
    log(f"  summary at N={BENCH_N}: {host:.1f} ms on the card (wall), "
        f"{cpu_s:.1f} s on the CPU copy; suggested_dt bit-equal: "
        f"{s_k['suggested_dt'] == s_c['suggested_dt']}")
    u = s_k["potential_energy"]
    pe_ms = cuda_ms(lambda: diagnostics.potential_energy(w.state, w.mass_len))
    u_pm = float(diagnostics.potential_energy_pm(w.state, w.mass_len))
    check(f"potential_energy_pm vs potential_energy at N={BENCH_N}",
          abs(u_pm - u) / abs(u), PE_PM_BOUND)
    big = nt.create_world(scene_big, device=device)
    pm_ms = cuda_ms(lambda: diagnostics.potential_energy_pm(
        big.state, big.mass_len), reps=3)
    out["diagnostics"] = {"summary_ms": host, "cpu_s": cpu_s,
                          "potential_ms": pe_ms, "pm_big_ms": pm_ms}
    log(f"  potential_energy at N={BENCH_N} {pe_ms:.4f} ms; "
        f"potential_energy_pm (grid 512) at N={BIG_N} {pm_ms:.4f} ms")
    del w, big, cpu

    # D=4 shards on one card, N=65536: hooked and adaptive
    ref = nt.create_world(scene_bench, device=device)
    ref.update(HOOK_DT, HOOK_SUBSTEPS, extra_force=drag)
    out["sharded"] = {}
    for backend, counter in (("cuda_ring", rf), ("cuda", df)):
        sw = sharded(sh, scene_bench, 4, device, backend)
        counter.LAUNCHES = 0
        with no_sync():
            sw.update(HOOK_DT, HOOK_SUBSTEPS, extra_force=drag)
        torch.cuda.synchronize()
        launches = counter.LAUNCHES
        expect_launches(f"hooked sharded {backend} D=4", launches,
                        16 * HOOK_SUBSTEPS)
        gaps = check_gaps(f"hooked sharded {backend} D=4 vs hooked World",
                          sw, ref, SHARD_VS_WORLD)
        res = {"launches": launches, "gaps": gaps}
        if backend == "cuda_ring":
            # the hop kernel without its epilogue: one pass of the ring
            pos, rad, valid = sw.pos, sw.radius, sw.valid

            def ring_pass(kind):
                with sw.ring.fork():
                    acc = rf.ring_force(sw.ring, pos, rad, valid, backend=kind)
                return torch.cat(acc)
            got_, want_ = ring_pass("cuda_ring"), ring_pass("torch")
            check(f"ring_force hop kernel (no epilogue) vs plain, N={BENCH_N}"
                  f" D=4", rel(got_, want_), BOUND_SMALL)
            nn, mm = sw.total_len, sw.mass_len
            b_ms, b_by = bound(FLOPS_DIRECT * nn * mm, 20 * nn + 12 * mm,
                               MUFU_DIRECT * nn * mm)
            res.update(max_abs_err=float((got_ - want_).abs().max()),
                       ms=cuda_ms(lambda: ring_pass("cuda_ring"), reps=5),
                       plain_ms=cuda_ms(lambda: ring_pass("torch")),
                       bound_ms=b_ms, bound_by=b_by, n=nn, s=mm)
        sw2 = sharded(sh, scene_bench, 4, device, backend)
        counter.LAUNCHES = 0
        with no_sync(world_mod):
            k_s = sw2.update_adaptive(span)
        expect_launches(f"adaptive sharded {backend} D=4", counter.LAUNCHES,
                        16 * adaptive_evaluations(k_s))
        if k_s != out["adaptive"]["k"]:
            raise SystemExit(f"chip_smoke: adaptive sharded {backend} took "
                             f"{k_s} substeps, World {out['adaptive']['k']}")
        finite_state(sw2, f"adaptive sharded {backend}")
        log(f"  sharded {backend} D=4: hooked {launches} launches in "
            f"{HOOK_SUBSTEPS} substeps, no host sync; adaptive {k_s} "
            f"substeps (World {out['adaptive']['k']}), "
            f"{16 * adaptive_evaluations(k_s)} launches")
        out["sharded"][backend] = res
        del sw, sw2
    return out


# [16] collision merging and the CLI: the N=65536 scene merges in 10
# substeps of MERGE_DT (102 contacts at the start); the contact kernel's
# bound counts MERGE_FLOPS fp32 operations a candidate pair of its grid
# (collisions.grid_candidates) and MERGE_BYTES a row (pos 8, radius 4,
# mass 4, live 1 read; winner 8 written)
MERGE_DT = 0.01
MERGE_SUBSTEPS = 10
MERGE_FLOPS = 12
MERGE_BYTES = 25
MERGE_SRC = "nbody_tpu_torch/csrc/merge_contacts.cu"
MASS_BOUND = 1e-5
GM_RTOL = 1e-6
MERGE_ADAPTIVE_SUBSTEPS = 10


def synthetic_cluster(device, n: int = 4096):
    """A dense cluster with equal-mass ties, plus a chain of increasing
    masses in a row (one merge a pass): (pos, vel, radius, mass, gm)."""
    rng = np.random.default_rng(SEED)
    k = n - 512
    pos = np.concatenate([rng.uniform(-25, 25, (k, 2)),
                          np.stack([np.arange(512) * 1.0 + 100.0,
                                    np.zeros(512)], 1)])
    mass = np.concatenate([np.round(rng.uniform(0.5, 2.0, k) * 4) / 4,
                           np.arange(1, 513) * 1.0])
    radius = np.concatenate([np.full(k, 0.4), np.full(512, 0.6)])
    vel = rng.normal(0, 0.2, (n, 2))
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
         for a in (pos, vel, radius, mass)]
    gm = 10.0 * t[3]
    gm[::97] = 0.0                                    # some dead rows
    return (*t, gm)


def contact_inputs(pos, radius, mass, gm):
    m = gm.shape[0]
    return (pos[:m].contiguous(), radius[:m].contiguous(),
            mass[:m].contiguous(), gm > 0, 1.0)


def merge_bits(col, label, pos, vel, radius, mass, gm) -> int:
    """The contact kernel against contacts_plain and merge_pass against
    merge_pass_plain on identical inputs: bit-equal, or fail. Returns the
    losers."""
    args = contact_inputs(pos, radius, mass, gm)
    got = col.contacts(*args)
    want = col.contacts_plain(*args)
    full = col.merge_pass(pos, vel, radius, mass, gm, factor=1.0, g=10.0)
    plain = col.merge_pass_plain(pos, vel, radius, mass, gm, factor=1.0,
                                 g=10.0)
    torch.cuda.synchronize()
    same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and all(torch.equal(a, b) for a, b in zip(full, plain)))
    losers = int(got[0].sum())
    m = gm.shape[0]
    merged = int((full[3][:m] == 0).sum() - (mass[:m] == 0).sum())
    log(f"  {label}: M={m}, {losers} losers, {merged} merged; kernel vs "
        f"plain (is_loser, winner, whole pass) "
        f"{'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(f"chip_smoke: contact kernel differs from its plain "
                         f"version, {label}")
    return losers


def contact_bits(col, label, args) -> float:
    """The contact kernel against contacts_plain on ``args`` (contact
    inputs): bit-equal, or fail. Returns the plain version's ms."""
    got = col.contacts(*args)
    t0 = time.perf_counter()
    want = col.contacts_plain(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    log(f"  {label}: M={args[2].shape[0]}, {int(want[0].sum())} losers; "
        f"kernel vs contacts_plain {'bit-equal' if same else 'DIFFER'} "
        f"(plain {plain_s:.2f} s)")
    if not same:
        raise SystemExit(f"chip_smoke: contact kernel differs from its plain "
                         f"version, {label}")
    return plain_s * 1e3


def contact_timing(col, args, reps: int) -> dict:
    """The contact kernel's ms (its grid's set-up included) and its bound
    on these inputs: the candidate pairs its grid examines. Its set-up's
    grid must be contact_grid's, bit for bit."""
    col.contacts(*args)
    ms = cuda_ms(lambda: col.contacts(*args), reps=reps)
    m = args[2].shape[0]
    grid = col.contact_grid(args[0], args[1], args[3], args[4])
    mine = col.contact_grid_kernel(args[0], args[1], args[3], args[4])
    if not all(torch.equal(a, b) for a, b in zip(grid, mine)):
        raise SystemExit(f"chip_smoke: the contact kernel's grid differs "
                         f"from contact_grid's, M={m}")
    cand = int(col.grid_candidates(grid))
    b_ms, b_by = bound(MERGE_FLOPS * cand, MERGE_BYTES * m)
    return {"m": m, "ms": ms, "candidates": cand, "bound_ms": b_ms,
            "bound_by": b_by, "width": float(grid.width),
            "n_big": int(grid.big.sum())}


def check_merged(label, mass0, mass, gm, mass_len) -> int:
    """Gates of a merging run: merges happened, mass conserved, gm = g·mass
    below mass_len. Returns the merges."""
    m0 = float(mass0.double().sum())
    rel_mass = abs(float(mass.double().sum()) - m0) / m0
    merged = int((mass[:mass_len] == 0).sum())
    gm_err = float(((gm.cpu().double() - 10.0 * mass[:mass_len].double()).abs()
                    / (10.0 * mass[:mass_len].double()).abs().clamp(min=1e-30))
                   .max()) if mass_len else 0.0
    log(f"  {label}: {merged} merged rows, total mass rel change "
        f"{rel_mass:.3e} (bound {MASS_BOUND:.0e}), gm vs g*mass max rel "
        f"{gm_err:.3e} (bound {GM_RTOL:.0e})")
    if merged == 0 or not rel_mass < MASS_BOUND or not gm_err <= GM_RTOL:
        raise SystemExit(f"chip_smoke: merging gates failed, {label}")
    return merged


CONTACT_KERNELS = ("pack_kernel", "search_kernel", "big_kernel")


def profile_merging(world) -> dict:
    """A profiler window over MERGE_SUBSTEPS merging substeps, in device ms
    a substep: the kernels of the contact search (CONTACT_KERNELS), the
    fused direct kernel, every other kernel and copy (the grid's set-up
    and the scatter's PyTorch ops); the merge pass's own range (its
    record_function, first kernel to last, the gaps between them
    included); the card's busy time (the union of the kernels' and
    copies' intervals) and its idle share."""
    from torch.autograd import DeviceType

    def measure(events):
        work, ranges = [], []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            span = (e.time_range.start, e.time_range.end)
            if getattr(e, "is_user_annotation", False) or e.name == "merge_pass":
                ranges.append(span)
            else:
                work.append((*span, e.name))
        return (work, ranges) if work else None

    got, _, wall, event_ms = profile_window(
        lambda: world.update(MERGE_DT, MERGE_SUBSTEPS), measure)
    if got is None:
        nan = not_profiled("the merging substeps", event_ms / MERGE_SUBSTEPS)
        return {"contacts": nan, "direct": nan, "other": nan,
                "merge_range_ms": nan, "busy_ms": nan,
                "wall_ms": wall / MERGE_SUBSTEPS, "idle": nan}
    work, ranges = got
    by = {"contacts": 0.0, "direct": 0.0, "other": 0.0}
    for a, b, name in work:
        key = ("contacts" if any(k in name for k in CONTACT_KERNELS)
               else "direct" if "direct_forces_kernel" in name else "other")
        by[key] += (b - a) / 1e3 / MERGE_SUBSTEPS
    busy = union_ms([(a, b) for a, b, _ in work])
    return {**by, "merge_range_ms": sum(b - a for a, b in ranges) / 1e3
            / MERGE_SUBSTEPS, "busy_ms": busy / MERGE_SUBSTEPS,
            "wall_ms": wall / MERGE_SUBSTEPS, "idle": 1.0 - busy / wall}


def run_cli(args: list) -> float:
    """``python -m nbody_tpu_torch`` with ``args`` as a subprocess from the
    repository root; its wall seconds, or fail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nbody_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    tail = " | ".join(proc.stderr.strip().splitlines()[-3:])
    log(f"  $ python -m nbody_tpu_torch {' '.join(args)}: rc {proc.returncode}, "
        f"{secs:.1f} s wall; {tail}")
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: the CLI failed: {proc.stderr[-2000:]}")
    return secs


def phase_merge(nt, sh, df, rf, pp, world_mod, diagnostics, scene_bench,
                scene_big, device) -> dict:
    """[16]: collision merging (the contact kernel, World, ShardedWorld,
    p3m, adaptive) and the CLI."""
    from nbody_tpu_torch.ops import collisions as col
    from nbody_tpu_torch.utils import contact_scenes

    log(f"[16] collision merging: the contact kernel, N={BENCH_N} World and "
        f"D=4 shards, the N={BIG_N} p3m slice, adaptive; the CLI")
    out = {}
    # a. the kernel against its plain version
    ref = nt.create_world(scene_bench, device=device)
    ref.update(MERGE_DT, MERGE_SUBSTEPS)
    st = ref.state
    merge_bits(col, f"N={BENCH_N} after {MERGE_SUBSTEPS} substeps of "
               f"{MERGE_DT}", st.pos, st.vel, st.radius, st.mass, ref.gm)
    merge_bits(col, "synthetic cluster (ties, a chain, dead rows)",
               *synthetic_cluster(device))
    for kind in contact_scenes.KINDS:
        for factor in (1.0, 1.5):
            contact_bits(col, f"scene {kind}, factor {factor}",
                         (*contact_scenes.contact_scene(kind, device), factor))
    args = contact_inputs(st.pos, st.radius, st.mass, ref.gm)
    kt = contact_timing(col, args, reps=20)
    plain_ms = cuda_ms(lambda: col.contacts_plain(*args))
    big = nt.create_world(scene_big, device=device)
    big_args = contact_inputs(big.state.pos, big.state.radius,
                              big.state.mass, big.gm)
    bt = contact_timing(col, big_args, reps=5)
    for label, t in ((f"N={BENCH_N}", kt), (f"N={BIG_N}", bt)):
        log(f"  contact kernel {label} M={t['m']}: {t['ms']:.4f} ms; its grid "
            f"(bit-equal to contact_grid's; cells {t['width']:.6g} wide, "
            f"{t['n_big']} big rows) examines "
            f"{t['candidates']} candidate pairs against M² = "
            f"{t['m'] ** 2:.4e}; bound {t['bound_ms']:.6f} ms by "
            f"{t['bound_by']}, {t['bound_ms'] / t['ms']:.2%} of it")
    log(f"  contact plain N={BENCH_N}: {plain_ms:.4f} ms")
    del ref, big, big_args
    out["kernel"] = {**kt, "plain_ms": plain_ms, "big": bt}

    # b. the merging World, twice from one state
    cfg = nt.SimConfig(merge_collisions=True)
    w1 = nt.create_world(scene_bench, config=cfg, device=device)
    w2 = nt.create_world(scene_bench, config=cfg, device=device)
    mass0 = w1.state.mass.clone()
    col.LAUNCHES = 0
    df.LAUNCHES = 0
    with no_sync():
        w1.update(MERGE_DT, MERGE_SUBSTEPS)
    launches = (col.LAUNCHES, df.LAUNCHES)
    expect_launches("merging World, contact kernel", launches[0], MERGE_SUBSTEPS)
    expect_launches("merging World, fused substep", launches[1], MERGE_SUBSTEPS)
    w2.update(MERGE_DT, MERGE_SUBSTEPS)
    a, b = w1.particles, w2.particles
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in
               ("pos", "vel", "acc", "mass", "radius")) and torch.equal(w1.gm, w2.gm)
    if not same or not all(torch.isfinite(x).all() for x in (a.pos, a.vel)):
        raise SystemExit("chip_smoke: merging World not bit-equal run to run")
    merged = check_merged(f"merging World N={BENCH_N}", mass0, a.mass, w1.gm,
                          w1.mass_len)
    log(f"  merging World: {launches[0]} contact and {launches[1]} fused "
        f"launches in {MERGE_SUBSTEPS} substeps, no host sync; two runs "
        f"bit-equal")
    plain_w = nt.create_world(scene_bench, device=device)
    plain_w.update(MERGE_DT, MERGE_SUBSTEPS)
    runs = {"unmerged": [], "merging": []}
    for kind in ("unmerged", "merging", "merging", "unmerged"):
        w = w1 if kind == "merging" else plain_w
        dev, host, _ = timed(lambda: w.update(MERGE_DT, MERGE_SUBSTEPS))
        runs[kind].append((dev / MERGE_SUBSTEPS, host / MERGE_SUBSTEPS))
    times = {k: (float(np.mean([d for d, _ in v])),
                 float(np.mean([h for _, h in v]))) for k, v in runs.items()}
    log(f"  ms/substep, device (host), in turns: merging "
        f"{times['merging'][0]:.4f} ({times['merging'][1]:.4f}), unmerged "
        f"{times['unmerged'][0]:.4f} ({times['unmerged'][1]:.4f}); runs "
        f"{runs}")
    prof = profile_merging(w1)
    log(f"  merging profiler window, {MERGE_SUBSTEPS} substeps: device ms a "
        f"substep, contact search {prof['contacts']:.4f}, fused direct "
        f"kernel {prof['direct']:.4f}, every other kernel and copy (the "
        f"scatter) {prof['other']:.4f}; the merge pass's range "
        f"{prof['merge_range_ms']:.4f}; card busy {prof['busy_ms']:.4f} of "
        f"{prof['wall_ms']:.4f} wall (idle {prof['idle']:.2%}, the "
        f"profiler's host cost included)")
    out["world"] = {"launches": launches[0], "merged": merged, "times": times,
                    "profile": prof}
    del w2, plain_w

    # c. D=4 shards on one card, "cuda_ring"
    def shards():
        return sh.ShardedWorld(scene_bench, sh.make_mesh(devices=[device] * 4),
                               config=cfg, force_backend="cuda_ring")
    s1, s2 = shards(), shards()
    col.LAUNCHES = 0
    rf.LAUNCHES = 0
    with no_sync():
        s1.update(MERGE_DT, MERGE_SUBSTEPS)
    expect_launches("merging D=4, contact kernel", col.LAUNCHES, MERGE_SUBSTEPS)
    expect_launches("merging D=4, hop kernel", rf.LAUNCHES, 16 * MERGE_SUBSTEPS)
    s2.update(MERGE_DT, MERGE_SUBSTEPS)
    p1, p2 = s1.particles, s2.particles
    if not (all(torch.equal(getattr(p1, f), getattr(p2, f)) for f in
                ("pos", "vel", "acc", "mass", "radius"))
            and torch.equal(s1.gm_src, s2.gm_src)):
        raise SystemExit("chip_smoke: merging D=4 not bit-equal run to run")
    finite_state(s1, "merging D=4")
    check_merged("merging D=4 cuda_ring", mass0, p1.mass,
                 s1.gm_src[:s1.mass_len], s1.mass_len)
    w_ref = nt.create_world(scene_bench, config=cfg, device=device)
    w_ref.update(MERGE_DT, MERGE_SUBSTEPS)
    differ = int((p1.mass != w_ref.particles.mass).sum())
    log(f"  merging D=4 cuda_ring: {MERGE_SUBSTEPS} contact and "
        f"{16 * MERGE_SUBSTEPS} hop launches, no host sync, two runs "
        f"bit-equal; {differ} mass rows differ from the World's (not gated)")
    out["sharded"] = {"differ": differ}
    del s1, s2, w_ref

    # d. p3m merging at the N=1M slice config, rebin 1
    pcfg = nt.SimConfig(merge_collisions=True, **P3M_SIZED)
    pw = nt.create_world(scene_big, config=pcfg, device=device)
    pmass0 = pw.state.mass.clone()
    col.LAUNCHES = 0
    pp.LAUNCHES = 0
    with no_sync():
        dev, host, _ = timed(lambda: pw.update(MERGE_DT, 2, backend="p3m"))
    expect_launches("p3m merging, contact kernel", col.LAUNCHES, 2)
    expect_launches("p3m merging, K4", pp.LAUNCHES, 2)
    finite = all(torch.isfinite(x).all() for x in
                 (pw.particles.pos, pw.particles.vel))
    if not finite:
        raise SystemExit("chip_smoke: non-finite p3m merging state")
    p_merged = check_merged(f"p3m merging N={BIG_N} slice", pmass0,
                            pw.particles.mass, pw.gm, pw.mass_len)
    log(f"  p3m merging N={BIG_N}: {dev / 2:.4f} ms/substep device, "
        f"{host / 2:.4f} host, {p_merged} merged rows in 2 substeps")
    # the merged state, every row of its prefix, against the O(M²) plain
    # version (~16 s on the card)
    pst = pw.state
    big_plain = contact_bits(
        col, f"N={BIG_N} slice after 2 merging p3m substeps, every row",
        contact_inputs(pst.pos, pst.radius, pst.mass, pw.gm))
    out["p3m"] = {"ms": dev / 2, "host_ms": host / 2, "merged": p_merged,
                  "contacts_plain_ms": big_plain}
    del pw

    # e. adaptive with merging, "cuda" and "torch"
    probe = nt.create_world(scene_bench, device=device)
    probe.update(0.0, 1)
    span = MERGE_ADAPTIVE_SUBSTEPS * float(diagnostics.suggest_dt(probe.state))
    del probe
    ak = nt.create_world(scene_bench, config=cfg, device=device)
    with no_sync(world_mod):
        a_dev, _, k = timed(lambda: ak.update_adaptive(span))
    ap = nt.create_world(scene_bench, config=cfg, device=device)
    k_p = ap.update_adaptive(span, backend="torch")
    if not all(torch.isfinite(x).all() for x in (ak.particles.pos,
                                                  ak.particles.vel)):
        raise SystemExit("chip_smoke: non-finite adaptive merging state")
    rel_mass = abs(float(ak.particles.mass.double().sum())
                   - float(mass0.double().sum())) / float(mass0.double().sum())
    if not rel_mass < MASS_BOUND:
        raise SystemExit("chip_smoke: adaptive merging lost mass")
    a_merged = int((ak.particles.mass[:ak.mass_len] == 0).sum())
    log(f"  adaptive merging, span {span:.6g}: 'cuda' {k} substeps "
        f"({a_dev / max(k, 1):.4f} ms a substep), 'torch' {k_p} substeps; "
        f"{a_merged} merged rows, mass rel change {rel_mass:.3e} (bound "
        f"{MASS_BOUND:.0e})")
    out["adaptive"] = {"k": k, "k_torch": k_p}
    del ak, ap

    # f. the CLI, as a user runs it
    tmp = ROOT / "build" / "chip_smoke_cli"
    tmp.mkdir(parents=True, exist_ok=True)
    f = {name: str(tmp / name) for name in
         ("T.npz", "S.npz", "F.ppm", "S2.npz", "A.npz")}
    secs = [
        run_cli(["run", "--n", str(BENCH_N), "--galaxies", "2", "--seed",
                 str(SEED), "--steps", "20", "--merge", "--traj", f["T.npz"],
                 "--frames", "4", "--save", f["S.npz"]]),
        run_cli(["render", "--state", f["S.npz"], "--out", f["F.ppm"]]),
        run_cli(["run", "--state", f["S.npz"], "--steps", "5", "--save",
                 f["S2.npz"]]),
        run_cli(["gif", "--n", "4096", "--frames", "3", "--out", f["A.npz"]]),
    ]
    with np.load(f["T.npz"]) as d:
        ok = d["traj"].shape == (4, BENCH_N, 2) and np.isfinite(d["traj"]).all()
    with np.load(f["S.npz"]) as d:
        ok &= d["pos"].shape == (BENCH_N, 2) and int(d["step"]) == 20
        ok &= int((d["mass"] == 0).sum()) > int((scene_bench.mass == 0).sum())
    ok &= Path(f["F.ppm"]).read_bytes().startswith(b"P6\n1280 720\n255\n")
    with np.load(f["S2.npz"]) as d:
        ok &= int(d["step"]) == 25
        ok &= json.loads(str(d["sim_config"]))["merge_collisions"] is True
    with np.load(f["A.npz"]) as d:
        ok &= d["frames"].shape == (3, 360, 640, 3)
    if not ok:
        raise SystemExit("chip_smoke: the CLI's files are not as expected")
    log(f"  CLI: run {secs[0]:.1f} s, render {secs[1]:.1f} s, resume "
        f"{secs[2]:.1f} s, gif {secs[3]:.1f} s (wall, each a fresh process); "
        f"files and shapes as expected, the resume kept merge_collisions")
    out["cli"] = secs
    return out


# [17] differentiable rollouts. The VJP kernels against their plain versions:
# max|d|/max|ref| of each cotangent below BOUND_VJP (the same fp32 formulas
# summed in another order, with FMA contraction; a cotangent sums terms of
# both signs, as a force does, so its error is relative to the largest;
# 2e-5 is the bound of the force at S = 524704). The "cuda" rollout against
# World.update within AD_VALUE of max|pos| (the same launches; tensor and
# float dt round alike); against the "torch" rollout within AD_GRAD (JAX's
# bound between "pallas" and "jnp", tests/test_autodiff.py:87-103); the D=4
# sharded rollout against the single-device one within JAX's bounds
# (tests/test_autodiff.py:133-167).
VJP_SRC = "nbody_tpu_torch/csrc/direct_vjp.cu"
PP_VJP_SRC = "nbody_tpu_torch/csrc/p3m_pp_vjp.cu"
BOUND_VJP = 2e-5
AD_DT = 0.01
AD_STEPS = 10
AD_SMALL_N = 8192
AD_SMALL_STEPS = 3
AD_P3M_STEPS = 2
AD_SHARDED_STEPS = 3
AD_VALUE = 1e-6
AD_LOSS = 1e-5                  # tests/test_autodiff.py:98, forward parity
AD_GRAD = 1e-4
AD_SHARD_VALUE, AD_SHARD_GRAD = 1e-5, 3e-5
# What the VJPs must do, counted once a pair (each kernel computes a pair
# once), an FMA as two operations, as
# FLOPS_DIRECT counts them. The direct VJP, 29 a pair: d (2), r2 (4), k =
# inv³ (2), f (1), s = g·d (3), e = −1.5·f·s/r2 (3), 2e (1), f·g + 2e·d
# (6), the target's three sums (3), the source's three (4). MUFU: rsqrt
# alone gives k and 1/r2 = inv²; precise needs a sqrt and a reciprocal.
# K4's VJP, 5 a candidate pair (d and d², as K4) and 55 a pair inside rc:
# r2 and q2 (2), exact3 and smooth3 from inv and invq (4), su and 0.5/su
# from one rsqrt of d²+1e-12 (3), u (2), the taper (7), its derivative
# (6), h (2), s = g·d (3), s·gm (1), te (3), ts and tt (4), k2 = 2(te − tt
# − taper·ts) (4), w (1), c = w·g + k2·d (6), the target's three sums
# (3), the source's three (4); with 3 MUFU (the three rsqrt: 1/r2 and 1/q2
# are their squares). Timed as the rollouts run it: rsqrt.
FLOPS_DIRECT_VJP = 29
MUFU_DIRECT_VJP = {False: 1, True: 2}
FLOPS_PP_VJP = 55
MUFU_PP_VJP = 3
PP_VJP_KERNELS = 2                # the pass and the sums, a call
VJP_NAMES = ("d_tgt_pos", "d_tgt_radius", "d_src_pos", "d_src_gm")


def cotangent(n: int, device, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 2)).astype(np.float32)).to(device)


def check_vjp(label: str, got, again, want, names) -> float:
    """The kernel's cotangents twice bit-equal, finite, and each within
    BOUND_VJP of the plain version's (an all-zero reference must be met by
    zeros); returns the largest max|d|."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"chip_smoke: {label}: two runs not bit-equal")
    worst = 0.0
    for name, a, w in zip(names, got, want):
        if not torch.isfinite(a).all():
            raise SystemExit(f"chip_smoke: {label} {name}: not finite")
        if not w.abs().sum():
            if a.abs().sum():
                raise SystemExit(f"chip_smoke: {label} {name}: not zero")
            continue
        check(f"{label} {name}", rel(a, w), BOUND_VJP)
        worst = max(worst, float((a - w).abs().max()))
    return worst


def direct_vjp_case(df, label, args) -> float:
    """force_acc_vjp against force_acc_vjp_plain, rsqrt and precise."""
    worst = 0.0
    for precise in (False, True):
        got = df.force_acc_vjp(*args, precise=precise)
        again = df.force_acc_vjp(*args, precise=precise)
        want = df.force_acc_vjp_plain(*args, precise=precise)
        worst = max(worst, check_vjp(
            f"{label} {'precise' if precise else 'rsqrt'}", got, again, want,
            VJP_NAMES))
    return worst


def summed_pos_cotangent(d, rows) -> torch.Tensor:
    """The cotangent of the source positions when target i is the row
    rows[i] of the array the sources are the first rows of (as autograd
    sums them for p and p[:m]): d_src_pos plus d_tgt_pos of the targets
    that are sources, in float64."""
    out = d[2].double().clone()
    mine = rows < out.shape[0]
    out[rows[mine]] += d[0].double()[mine]
    return out


def vjp_vs_float64(df, label, args, rows) -> None:
    """The summed position cotangent (summed_pos_cotangent) of the kernel
    and of the fp32 plain version against the plain version in float64,
    precise. Where a target is its own source, its cotangent is the
    difference of two large terms (f·g of the pair with itself, once
    as a target and once as a source), which fp32 resolves only to the
    last bits of those terms: the kernel is held to no worse than three
    times the fp32 plain version (or BOUND_VJP, the larger)."""
    ref = summed_pos_cotangent(df.force_acc_vjp_plain(
        *(a.double() for a in args), precise=True), rows)
    plain = rel(summed_pos_cotangent(df.force_acc_vjp_plain(
        *args, precise=True), rows), ref)
    got = rel(summed_pos_cotangent(df.force_acc_vjp(*args, precise=True),
                                   rows), ref)
    log(f"  {label}: the summed position cotangent against float64: fp32 "
        f"plain {plain:.3e}")
    check(f"{label} summed position cotangent against float64", got,
          max(BOUND_VJP, 3 * plain))


def direct_vjp_bound(t: int, s: int, precise: bool) -> tuple[float, str]:
    """The direct VJP's bound: each pair once; inputs (pos, radius, g of the
    targets, pos and gm of the sources) read and the four cotangents
    written once."""
    return bound(FLOPS_DIRECT_VJP * t * s, 32 * t + 24 * s,
                 MUFU_DIRECT_VJP[precise] * t * s)


def pp_vjp_bound(c: dict, n_s: int) -> tuple[float, str]:
    """K4's VJP's bound on the cells route (pair_counts; n_s source rows):
    5 operations a candidate pair, FLOPS_PP_VJP and MUFU_PP_VJP a pair
    inside rc (rsqrt, as it is timed); the live rows (16 bytes), the targets' cotangents (8), the
    run arrays read once, the (n, 4) row cotangents of both sides written
    once."""
    nbytes = (16 * (c["live_t"] + c["live_s"]) + 8 * c["live_t"]
              + 16 * c["cells"] + 16 * (c["n_t"] + n_s))
    return bound(5 * c["candidates"] + FLOPS_PP_VJP * c["inside"], nbytes,
                 MUFU_PP_VJP * c["inside"])


def pp_vjp_case(pp, label, cells, rc, cap: int, cells_sub=None) -> float:
    """pp_cells_vjp against pp_cells_vjp_plain, rsqrt and precise; with
    ``cells_sub`` on those cells' rows only."""
    g = cotangent(cells[0].shape[0], cells[0].device, seed=3)
    kw = {"cap_t": cap, "cap_s": cap}
    worst = 0.0
    for precise in (False, True):
        got = pp.pp_cells_vjp(*cells, rc, 4.0, g, precise=precise, **kw)
        again = pp.pp_cells_vjp(*cells, rc, 4.0, g, precise=precise, **kw)
        want = pp.pp_cells_vjp_plain(*cells, rc, 4.0, g, precise=precise,
                                     cells=cells_sub, **kw)
        if cells_sub is not None:
            keep = [torch.zeros(x.shape[0], dtype=torch.bool,
                                device=x.device) for x in cells[:2]]
            for k, (start, counts) in enumerate(((cells[2], cells[3]),
                                                 (cells[4], cells[5]))):
                idx, live = pp.run_slots(start, counts, cap, keep[k].shape[0])
                mine = live & torch.isin(
                    torch.arange(counts.numel(), device=counts.device),
                    cells_sub)[:, None]
                keep[k][idx[mine]] = True
            got = [x[m] for x, m in zip(got, keep)]
            again = [x[m] for x, m in zip(again, keep)]
            want = [x[m] for x, m in zip(want, keep)]
        worst = max(worst, check_vjp(
            f"{label} {'precise' if precise else 'rsqrt'}",
            [x[:, :3] for x in got], [x[:, :3] for x in again],
            [x[:, :3] for x in want], ("d_trows", "d_srows")))
    return worst


def pp_vjp_timing(pp, label, cells, rc, cap: int, reps: int) -> dict:
    """K4's VJP on these runs, rsqrt: ms a call (CUDA events), its bound
    and share, a profiler window's kernel launches a call and device ms of
    the pass, the sums and the rest, and the plan: R, tasks, scratch, and
    the longest task (rows one warp walks) against K4's form (the parent's
    VJP: a warp a tile walking its cell's whole neighbourhood)."""
    from nbody_tpu_torch.ablations.tune_pp_vjp import device_split, task_rows

    n_t, n_s = cells[0].shape[0], cells[1].shape[0]
    gc = math.isqrt(cells[3].numel())
    g = cotangent(n_t, cells[0].device, seed=3)
    kw = {"cap_t": cap, "cap_s": cap}

    def call():
        return pp.pp_cells_vjp(*cells, rc, 4.0, g, **kw)

    call()      # the scratch's blocks back in the allocator's cache
    before = pp.VJP_LAUNCHES
    ms = cuda_ms(call, reps=reps)
    expect_launches(f"{label}: VJP_LAUNCHES a call", pp.VJP_LAUNCHES - before,
                    reps)
    for attempt in range(1, PROFILE_TRIES + 1):
        # the profiler on an H100 has dropped a whole window's device
        # events: a window that saw other than the call's kernels is run
        # again, as profile_window runs its windows
        split = device_split(call)
        if split["kernels"] == PP_VJP_KERNELS:
            break
        log(f"  profiler window {attempt} of {PROFILE_TRIES} saw "
            f"{split['kernels']} of the {PP_VJP_KERNELS} kernels a call")
    expect_launches(f"{label}: kernels a call", split["kernels"],
                    PP_VJP_KERNELS)
    plan = pp.vjp_plan(cells[3], cells[5], gc, cap, cap)
    t = task_rows(cells[3], cells[5], gc, cap, cap, plan.rows)
    mib = pp.vjp_scratch_bytes(n_t, n_s, plan) / 2 ** 20
    c = pair_counts(cells, rc, cap)
    b_ms, b_by = pp_vjp_bound(c, n_s)
    log(f"  {label}: {ms:.4f} ms a call (bound {b_ms:.4f} ms by {b_by}, "
        f"{b_ms / ms:.1%} of it; {c['inside']:.4e} pairs inside rc); one "
        f"VJP_LAUNCHES a call, {split['kernels']} kernel launches: device ms "
        f"pass {split['pass_ms']:.4f}, sums {split['sums_ms']:.4f}, the rest "
        f"{split['rest_ms']:.4f}")
    log(f"  {label}: R={plan.rows}, {t['tasks_after']} tasks of a block "
        f"({t['tasks_before']} in K4's form), scratch {mib:.1f} MiB; the "
        f"longest task {t['longest_after']} rows a warp, {t['longest_before']}"
        f" in K4's form; {t['warp_iterations']:.4e} warp iterations, each once")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "scratch_mib": mib,
            "split": split, "tasks": t}


def vjp_loops(_build, sass) -> None:
    """K4's VJP pass kernel, rsqrt and precise: its batch loop (the largest
    innermost loop, 8 staged rows against a tile) in SASS instructions,
    MUFU operations and shuffles, from the build; rsqrt must take 3 MUFU a
    pair."""
    funcs = sass.functions(_build.library_path("p3m_pp_vjp"))
    for precise in (False, True):
        code = funcs[sass.find(funcs, rf"vjp_kernelILb{int(precise)}E")]
        n, mufu = sass.pair_loop(code, "MUFU")
        shfl = sass.pair_loop(code, "SHFL")[1]
        log(f"  K4 VJP {'precise' if precise else 'rsqrt'}: batch loop {n} "
            f"SASS instructions for 8 rows, {n / 8:.1f} a row; {mufu} MUFU "
            f"({mufu / 8:g} a pair), {shfl} shuffles")
        if not precise and mufu != 8 * MUFU_PP_VJP:
            raise SystemExit(f"chip_smoke: K4 VJP rsqrt takes {mufu / 8:g} "
                             f"MUFU a pair, not {MUFU_PP_VJP}")


def densest_block(counts: torch.Tensor, side: int = 8) -> torch.Tensor:
    """The cells of a side × side window of the grid around its fullest
    cell (clipped to the grid)."""
    gc = math.isqrt(counts.numel())
    c = int(torch.argmax(counts))
    i0 = min(max(c // gc - side // 2, 0), gc - side)
    j0 = min(max(c % gc - side // 2, 0), gc - side)
    ii = torch.arange(i0, i0 + side, device=counts.device)
    jj = torch.arange(j0, j0 + side, device=counts.device)
    return (ii[:, None] * gc + jj[None, :]).reshape(-1)


def rel_off(got: torch.Tensor, want: torch.Tensor, row: int) -> float:
    """rel over every row but ``row``. A loss on one tracer has its largest
    gradient in the tracer's own row, about 2(p − target), which hides the
    other rows: theirs comes through the sources' cotangents alone."""
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    keep[row] = False
    return rel(got[keep], want[keep])


def rollout_grads(loss, state, dt, **kw):
    """(loss, d loss / d (pos0, vel0, mass, radius, dt)) of one rollout
    from the state's tensors."""
    xs = [x.detach().clone().requires_grad_()
          for x in (state.pos, state.vel, state.mass, state.radius)]
    d = dt.detach().clone().requires_grad_()
    val = loss(*xs, d, **kw)
    return val, torch.autograd.grad(val, [*xs, d])


def peak_mib(fn) -> tuple[float, object]:
    """(MiB allocated above the start at the peak of fn, fn's result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20, out


def phase_autodiff(nt, df, pp, p3m_forces, _build, sass, scene_bench,
                   scene_big, slice_w, device) -> dict:
    """[17]: the VJP kernels and the differentiable rollouts on the card."""
    from nbody_tpu_torch import autodiff
    from nbody_tpu_torch.parallel import make_mesh

    log(f"[17] differentiable rollouts: the VJP kernels, the 'cuda' rollout "
        f"at N={BENCH_N}, 'cuda' against 'torch' at N={AD_SMALL_N}, the "
        f"'p3m' rollout at the N={BIG_N} slice, D=4 shards on one card")
    t0 = time.perf_counter()
    out = {}
    # a. the direct VJP against its plain version. The random sources lie
    # apart from the targets; the trap case puts zero-radius targets on
    # gm = 0 sources at their own positions.
    pos, _, radius, gm = random_state(1000, 333, device)
    src = pos[:333] + 7.0
    g = cotangent(1000, device)
    worst = direct_vjp_case(df, "K1 VJP N=1000 S=333",
                            (pos, radius, src, gm, g))
    direct_vjp_case(df, "K1 VJP N=1000 S=0",
                    (pos, radius, src[:0], gm[:0], g))
    trap_r = radius.clone()
    trap_r[:500] = 0.0
    direct_vjp_case(df, "K1 VJP zero-radius tracers on gm = 0 sources",
                    (pos, trap_r, pos[:500], torch.zeros(500, device=device),
                     g))
    bench = nt.create_world(scene_bench, device=device)
    st, m = bench.state, bench.mass_len
    g = cotangent(BENCH_N, device, seed=1)
    args = (st.pos, st.radius, st.pos[:m], bench.gm, g)
    worst = max(worst, direct_vjp_case(df, f"K1 VJP N={BENCH_N} S={m}", args))
    vjp_vs_float64(df, f"K1 VJP N={BENCH_N} S={m}", args,
                   torch.arange(BENCH_N, device=device))
    ms = {p: cuda_ms(lambda p=p: df.force_acc_vjp(*args, precise=p), reps=5)
          for p in (False, True)}
    plain_ms = cuda_ms(lambda: df.force_acc_vjp_plain(*args, precise=True))
    b_ms, b_by = direct_vjp_bound(BENCH_N, m, True)
    rb_ms, rb_by = direct_vjp_bound(BENCH_N, m, False)
    plan = df.vjp_plan(BENCH_N, m, df.device_sms(device)).describe()
    log(f"  K1 VJP N={BENCH_N} S={m}: precise {ms[True]:.4f} ms (bound "
        f"{b_ms:.4f} ms by {b_by}, {b_ms / ms[True]:.1%} of it), rsqrt "
        f"{ms[False]:.4f} ms (bound {rb_ms:.4f} ms by {rb_by}, "
        f"{rb_ms / ms[False]:.1%} of it); plain {plain_ms:.2f} ms; plan "
        f"{plan}")
    out["k1"] = {"n": BENCH_N, "s": m, "ms": ms[True], "rsqrt_ms": ms[False],
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    sst, sm = slice_w.state, slice_w.mass_len
    rows = p3m_forces.exact_core_rows(sst.radius,
                                      slice_w.config.p3m_exact_targets)
    tp, tr = sst.pos[rows].contiguous(), sst.radius[rows].contiguous()
    core = (tp, tr, sst.pos[:sm], slice_w.gm, cotangent(tp.shape[0], device))
    worst = max(worst, direct_vjp_case(
        df, f"K1 VJP exact-core rows T={tp.shape[0]} S={sm}", core))
    vjp_vs_float64(df, f"K1 VJP exact-core rows T={tp.shape[0]} S={sm}",
                   core, rows)
    core_ms = cuda_ms(lambda: df.force_acc_vjp(*core), reps=5)
    core_b = direct_vjp_bound(tp.shape[0], sm, False)
    log(f"  K1 VJP T={tp.shape[0]} S={sm}: {core_ms:.4f} ms (bound "
        f"{core_b[0]:.4f} ms by {core_b[1]}); plan "
        f"{df.vjp_plan(tp.shape[0], sm, df.device_sms(device)).describe()}")
    out["k1"]["max_abs_err"] = worst
    out["k1"]["core_ms"] = core_ms

    # b. K4's VJP against its plain version
    vjp_loops(_build, sass)
    cells, _, rc = random_cells(pp, device)
    pp_worst = pp_vjp_case(pp, "K4 VJP random 8x8 cells cap 32", cells, rc, 32)
    default_w = nt.create_world(scene_bench, config=nt.SimConfig(**P3M_DEFAULT),
                                device=device)
    cap = P3M_DEFAULT["p3m_cell_capacity"]
    cells, _, rc = world_cells(pp, p3m_forces, default_w)
    label = f"K4 VJP N={BENCH_N} grid {P3M_DEFAULT['pm_grid']} cap={cap}"
    pp_worst = max(pp_worst, pp_vjp_case(pp, label, cells, rc, cap))
    k4 = pp_vjp_timing(pp, label, cells, rc, cap, reps=10)
    g = cotangent(cells[0].shape[0], device, seed=3)
    k4["plain_ms"] = cuda_ms(lambda: pp.pp_cells_vjp_plain(
        *cells, rc, 4.0, g, cap_t=cap, cap_s=cap))
    log(f"  {label}: plain {k4['plain_ms']:.2f} ms")
    del default_w
    cap = P3M_SIZED["p3m_cell_capacity"]
    cells, _, rc = world_cells(pp, p3m_forces, slice_w)
    block = densest_block(cells[3])
    label = f"K4 VJP N={BIG_N} grid {P3M_SIZED['pm_grid']} cap={cap}"
    pp_worst = max(pp_worst, pp_vjp_case(
        pp, f"{label} (the 8x8 cells around the fullest)", cells, rc, cap,
        cells_sub=block))
    big = pp_vjp_timing(pp, label, cells, rc, cap, reps=5)
    k4.update(max_abs_err=pp_worst, big_ms=big["ms"],
              big_bound_ms=big["bound_ms"], big=big)
    out["k4"] = k4
    del cells, g

    # c. the "cuda" rollout at full width
    cfg = nt.SimConfig(precise=True)
    world = nt.create_world(scene_bench, config=cfg, device=device)
    st, ml = world.state, world.mass_len
    tracer = ml
    target = st.pos[tracer] + 5.0
    loss = autodiff.trajectory_loss(target, tracer)
    dt = torch.full((), AD_DT, device=device)
    kw = dict(n_steps=AD_STEPS, mass_len=ml, backend="cuda", precise=True)
    df.LAUNCHES = df.VJP_LAUNCHES = 0
    with no_sync():
        val, grads = rollout_grads(loss, st, dt, **kw)
    torch.cuda.synchronize()
    launches = (df.LAUNCHES, df.VJP_LAUNCHES)
    expect_launches("'cuda' rollout, force_acc (forward and recomputed)",
                    launches[0], 2 * AD_STEPS)
    expect_launches("'cuda' rollout, K1 VJP kernel", launches[1], AD_STEPS)
    val2, grads2 = rollout_grads(loss, st, dt, **kw)
    if not all(torch.equal(a, b) for a, b in zip(grads, grads2)) \
            or not torch.equal(val, val2):
        raise SystemExit("chip_smoke: 'cuda' rollout gradients not bit-equal")
    if not all(torch.isfinite(x).all() for x in grads):
        raise SystemExit("chip_smoke: 'cuda' rollout gradients not finite")
    with torch.no_grad():
        p_roll, _ = autodiff.rollout(st.pos, st.vel, st.mass, st.radius, dt,
                                     **kw)
    world.update(AD_DT, AD_STEPS, extra_force=zero_hook)
    p_w = world.state.pos
    check(f"'cuda' rollout N={BENCH_N} vs World.update, pos", rel(p_roll, p_w),
          AD_VALUE)
    if not torch.equal(val.detach(), torch.sum((p_roll[tracer] - target) ** 2)):
        raise SystemExit("chip_smoke: the 'cuda' rollout's loss under autograd "
                         "differs from the same rollout's without it")
    fwd_ms = timed(lambda: autodiff.rollout(
        *(x.detach().clone().requires_grad_() for x in (st.pos, st.vel)),
        st.mass, st.radius, dt, **kw))[0] / AD_STEPS
    mib, (both_ms, _, _) = peak_mib(lambda: timed(
        lambda: rollout_grads(loss, st, dt, **kw)))
    both_ms /= AD_STEPS
    log(f"  'cuda' rollout N={BENCH_N} precise euler, {AD_STEPS} steps of "
        f"{AD_DT}, remat: launches {launches[0]} force_acc ({AD_STEPS} "
        f"forward, {AD_STEPS} recomputed), {launches[1]} K1 VJP passes; no "
        f"host sync; gradients finite and bit-equal twice; forward "
        f"{fwd_ms:.4f} ms/step, forward and backward {both_ms:.4f} ms/step, "
        f"peak {mib:.1f} MiB above the state")
    out["cuda"] = {"launches": launches[1], "fwd_ms": fwd_ms,
                   "both_ms": both_ms, "peak_mib": mib}
    del world

    # d. "cuda" against "torch" gradients at N=8192
    small = nt.create_world(nt.make_galaxies(AD_SMALL_N, 2, seed=SEED),
                            device=device)
    sst, sml = small.state, small.mass_len
    loss = autodiff.trajectory_loss(sst.pos[sml] + 5.0, sml)
    for integrator, steps in (("euler", AD_STEPS), ("leapfrog", AD_SMALL_STEPS),
                              ("yoshida4", AD_SMALL_STEPS)):
        kw = dict(n_steps=steps, mass_len=sml, precise=True,
                  integrator=integrator)
        v_c, g_c = rollout_grads(loss, sst, dt, backend="cuda", **kw)
        v_t, g_t = rollout_grads(loss, sst, dt, backend="torch", **kw)
        check(f"N={AD_SMALL_N} {integrator} {steps} steps: 'cuda' vs 'torch' "
              f"rollout loss", float((v_c - v_t).abs() / v_t.abs()), AD_LOSS)
        for name, a, b in zip(("pos0", "vel0", "mass", "radius", "dt"),
                              g_c, g_t):
            check(f"N={AD_SMALL_N} {integrator}: d loss / d {name}",
                  rel(a, b), AD_GRAD)
        off = [rel_off(a, b, sml) for a, b in zip(g_c[:2], g_t[:2])]
        log(f"  N={AD_SMALL_N} {integrator}: not gated, d loss / d pos0 "
            f"and vel0 without the tracer's row {off[0]:.3e} and "
            f"{off[1]:.3e} of their max (see f.)")
    # over one leapfrog step the other rows of d loss / d (pos0, vel0) are
    # each one pair's term of the tracer's force (see f.)
    kw = dict(n_steps=1, mass_len=sml, precise=True, integrator="leapfrog")
    _, g_c = rollout_grads(loss, sst, dt, backend="cuda", **kw)
    _, g_t = rollout_grads(loss, sst, dt, backend="torch", **kw)
    for name, a, b in zip(("pos0", "vel0"), g_c, g_t):
        check(f"N={AD_SMALL_N} leapfrog one step: d loss / d {name} but the "
              f"tracer's row", rel_off(a, b, sml), AD_GRAD)
    del small

    # e. the "p3m" rollout at the N=1M slice (and at N=65536 for K4's row)
    for key, scene, cfg_kw, n in (("p3m", scene_big, P3M_SIZED, BIG_N),
                                  ("p3m_default", scene_bench, P3M_DEFAULT,
                                   BENCH_N)):
        cfg = nt.SimConfig(**cfg_kw)
        w = nt.create_world(scene, config=cfg, device=device)
        st, ml = w.state, w.mass_len
        kw = dict(n_steps=AD_P3M_STEPS, mass_len=ml, backend="p3m",
                  precise=cfg.precise, g=cfg.g, pm_grid=cfg.pm_grid,
                  pm_softening=cfg.pm_softening,
                  p3m_rc_cells=cfg.p3m_rc_cells,
                  p3m_cell_capacity=cfg.p3m_cell_capacity,
                  p3m_exact_targets=cfg.p3m_exact_targets,
                  p3m_rebin_interval=cfg.p3m_rebin_interval,
                  integrator=cfg.integrator)

        def run(st=st, kw=kw):
            p = st.pos.detach().clone().requires_grad_()
            fin, _ = autodiff.rollout(p, st.vel, st.mass, st.radius, dt, **kw)
            return fin.detach(), torch.autograd.grad(torch.sum(fin ** 2), p)[0]

        df.LAUNCHES = df.VJP_LAUNCHES = pp.LAUNCHES = pp.VJP_LAUNCHES = 0
        with no_sync():
            fin, g1 = run()
        torch.cuda.synchronize()
        counts = {"K4": pp.LAUNCHES, "K4 VJP": pp.VJP_LAUNCHES,
                  "force_acc": df.LAUNCHES, "K1 VJP": df.VJP_LAUNCHES}
        for what, got in counts.items():
            # one VJP call of each a step, one pass a call; K4 and
            # force_acc forward and recomputed
            expect_launches(f"'p3m' rollout N={n}, {what}", got,
                            AD_P3M_STEPS if "VJP" in what
                            else 2 * AD_P3M_STEPS)
        _, g2 = run()
        if not torch.equal(g1, g2) or not torch.isfinite(g1).all():
            raise SystemExit(f"chip_smoke: 'p3m' rollout N={n}: gradient not "
                             "finite or not bit-equal twice")
        w.update(AD_DT, AD_P3M_STEPS, backend="p3m")
        check(f"'p3m' rollout N={n} vs World.update, pos",
              rel(fin, w.state.pos), AD_VALUE)
        fwd_ms = timed(lambda: autodiff.rollout(
            st.pos.detach().clone().requires_grad_(), st.vel, st.mass,
            st.radius, dt, **kw))[0] / AD_P3M_STEPS
        mib, (both_ms, _, _) = peak_mib(lambda: timed(run))
        both_ms /= AD_P3M_STEPS
        log(f"  'p3m' rollout N={n} grid {cfg.pm_grid} cap "
            f"{cfg.p3m_cell_capacity}, {AD_P3M_STEPS} steps: launches "
            f"{counts}; no host sync; the gradient finite and bit-equal "
            f"twice; forward {fwd_ms:.4f} ms/step, forward and backward "
            f"{both_ms:.4f} ms/step, peak {mib:.1f} MiB above the state")
        out[key] = {"launches": counts, "fwd_ms": fwd_ms, "both_ms": both_ms,
                    "peak_mib": mib}
        del w, fin, g1, g2

    # f. rollout_sharded "cuda", D=4 shards on one card, against the
    # single-device rollout, within nbody_tpu's bounds. Three gates:
    # - the loss of c. over AD_SHARDED_STEPS steps, value and gradient;
    # - the same loss over one step, the gradient without the tracer's own
    #   row (about 2(p − target), which hides the rest). Each other row's
    #   is then one pair's term of the tracer's force, reached only through
    #   the ring's backward (the copies between shards, the other shards'
    #   source-side VJP, the masks), so the two rollouts must agree on it
    #   to its last bits;
    # - nbody_tpu's own case (tests/test_autodiff.py:133-167): sum(pos²)
    #   on one galaxy of 500, AD_SHARDED_STEPS steps.
    # Printed, not gated: over several steps the other rows of the tracer's
    # gradient, and sum(pos²)'s on two galaxies, are small remainders of
    # large terms that cancel at a galaxy core (the central mass's row), so
    # two summation orders give them different low bits (nbody_tpu's own
    # ring and single-device rollouts differ by more than 3e-5 of max on
    # sum(pos²): tests/test_torch_autodiff.py::
    # test_sharded_gradient_conditioning).
    mesh = make_mesh(devices=[device] * 4)

    def sharded_run(st, ml, losses, sharded, steps=AD_SHARDED_STEPS):
        p = st.pos.detach().clone().requires_grad_()
        kw = dict(n_steps=steps, mass_len=ml, backend="cuda")
        if sharded:
            fin, _ = autodiff.rollout_sharded(p, st.vel, st.mass, st.radius,
                                              dt, mesh=mesh, **kw)
        else:
            fin, _ = autodiff.rollout(p, st.vel, st.mass, st.radius, dt, **kw)
        vals = [f(fin) for f in losses]
        return [(v, torch.autograd.grad(v, p, retain_graph=True)[0])
                for v in vals]

    st, ml = bench.state, bench.mass_len
    tracer = ml
    target = st.pos[tracer] + 5.0
    losses = (lambda a: torch.sum((a[tracer] - target) ** 2),
              lambda a: torch.sum(a ** 2))
    d_ms, _, (shd, sq_s) = timed(lambda: sharded_run(st, ml, losses, True))
    one, sq_1 = sharded_run(st, ml, losses, False)
    check(f"rollout_sharded D=4 N={BENCH_N} loss vs single device",
          float((shd[0] - one[0]).abs() / one[0].abs()), AD_SHARD_VALUE)
    check(f"rollout_sharded D=4 N={BENCH_N} gradient vs single device",
          rel(shd[1], one[1]), AD_SHARD_GRAD)
    (_, g1_s), = sharded_run(st, ml, losses[:1], True, steps=1)
    (_, g1_1), = sharded_run(st, ml, losses[:1], False, steps=1)
    check(f"rollout_sharded D=4 N={BENCH_N} one step, gradient vs single "
          f"device but the tracer's row", rel_off(g1_s, g1_1, tracer),
          AD_SHARD_GRAD)
    jw = nt.create_world(nt.make_galaxies(500, 1, seed=4), device=device)
    (jv_s, jg_s), = sharded_run(jw.state, jw.mass_len, losses[1:], True)
    (jv_1, jg_1), = sharded_run(jw.state, jw.mass_len, losses[1:], False)
    check("rollout_sharded D=4 one galaxy N=500 sum(pos²) vs single device",
          float((jv_s - jv_1).abs() / jv_1.abs()), AD_SHARD_VALUE)
    check("rollout_sharded D=4 one galaxy N=500 d sum(pos²) / d pos0 vs "
          "single device", rel(jg_s, jg_1), AD_SHARD_GRAD)
    log(f"  rollout_sharded 'cuda' D=4 on one card, {AD_SHARDED_STEPS} "
        f"steps: forward and backward {d_ms / AD_SHARDED_STEPS:.4f} ms/step "
        f"(two losses); not gated: the tracer's gradient without its row "
        f"{rel_off(shd[1], one[1], tracer):.3e} of their max, sum(pos²) at "
        f"N={BENCH_N}: value gap "
        f"{float((sq_s[0] - sq_1[0]).abs() / sq_1[0].abs()):.3e}, gradient "
        f"gap {rel(sq_s[1], sq_1[1]):.3e} of its max")
    out["sharded_ms"] = d_ms / AD_SHARDED_STEPS
    log(f"  [17] took {time.perf_counter() - t0:.1f} s")
    return out


# [18] the sharded mesh solvers on one card: D = MESH_SHARDS shards of the
# N=1M p3m slice and of the N=65536 default config, "p3m" and "pm",
# MESH_SUBSTEPS substeps of MESH_DT against the World on the same config.
# One evaluation of the sharded world differs from the World's by the
# order of the fp32 sums only (the shards' grids summed in shard order
# against one scatter; the exact-core partials), and close pairs amplify
# that from substep to substep, by an amount that depends on the scene.
# The bounds are set as [11]'s were, from MESH_SEEDS, each reading logged:
# the largest reading over the four seeds on an H100 80GB HBM3 (700 W),
# times 5, rounded down to one digit (measured, max|d|/max: p3m N=1M pos
# 6.196e-8, vel 3.315e-6, acc 1.540e-5; pm N=1M 2.502e-8, 1.061e-7,
# 1.507e-7; p3m N=65536 4.899e-9, 1.059e-7, 6.130e-7; D=1 bit-equal).
MESH_SHARDS = 4
MESH_SUBSTEPS = 3
MESH_DT = 0.01
MESH_SEEDS = (SEED, 1, 2, 3)
MESH_TIMED = 10
MESH_VS_WORLD = {("p3m", BIG_N): {"pos": 3e-7, "vel": 1.6e-5, "acc": 7e-5},
                 ("pm", BIG_N): {"pos": 1.2e-7, "vel": 5e-7, "acc": 7e-7},
                 ("p3m", BENCH_N): {"pos": 2e-8, "vel": 5e-7, "acc": 3e-6}}
MESH_STAGES = STAGES + ("shards.sum",)
AD_P3M_SHARDED_STEPS = 2


def mesh_world(nt, sh, scene, cfg, backend, d, device):
    return sh.ShardedWorld(scene, sh.make_mesh(devices=[device] * d),
                           config=nt.SimConfig(**cfg), force_backend=backend)


def mesh_gaps(nt, sh, scene, cfg, backend, device) -> tuple[dict, object]:
    """max|d|/max of pos, vel and acc of the D=MESH_SHARDS world against the
    World after MESH_SUBSTEPS substeps of MESH_DT from ``scene``; and the
    sharded world's particles."""
    w = nt.create_world(scene, config=nt.SimConfig(**cfg), device=device)
    sw = mesh_world(nt, sh, scene, cfg, backend, MESH_SHARDS, device)
    w.update(MESH_DT, MESH_SUBSTEPS, backend=backend)
    sw.update(MESH_DT, MESH_SUBSTEPS)
    a, b = sw.particles, w.particles
    if not all(torch.isfinite(x).all() for x in (a.pos, a.vel, a.acc)):
        raise SystemExit(f"chip_smoke: non-finite sharded {backend} state")
    return {f: rel(getattr(a, f), getattr(b, f))
            for f in ("pos", "vel", "acc")}, a


def shard_cells(pp, p3m_forces, sw) -> list:
    """For each shard of a "p3m" sharded world at its current state, the
    inputs its K4 launch gets (the shard's targets in cell order with each
    cell's count cut by the global-rank rule, the global sources in cell
    order) and rc."""
    bins = sw._p3m_bins(sw.pos, None)
    src, gm = sw._sources(sw.pos)
    srows = p3m_forces._cell_rows(torch.cat(src), torch.cat(gm),
                                  bins["order_s"][0])
    out = []
    for k in range(sw.n_devices):
        trows = p3m_forces._cell_rows(sw.pos[k], sw.radius[k] +
                                      pp.SOFTENING_FLOOR, bins["order_t"][k])
        cells = [trows, srows, bins["start_t"][k], bins["cut_t"][k],
                 bins["start_s"][k], bins["counts_s"][k]]
        dropped = int((bins["counts_t"][k].clamp(max=sw.config.p3m_cell_capacity)
                       - bins["cut_t"][k]).sum())
        out.append((cells, sw.config.p3m_rc_cells * bins["h"][k], dropped))
    return out


def compact_cut(pp, cells, cap: int) -> list:
    """The cut runs' live rows packed: the same work for K4 as ``cells``,
    with each run's length its count, as ``pair_counts`` reads them."""
    trows, srows, st, ct, ss, cs = cells
    idx, live = pp.run_slots(st, ct, cap, trows.shape[0])
    counts = ct.clamp(max=cap).to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return [trows[idx[live]].contiguous(), srows, starts, counts, ss, cs]


def shard_k4(pp, p3m_forces, sw, label: str, plain_all: bool) -> dict:
    """Each shard's K4 launch on a world's state against the plain version
    on the same inputs (every shard with ``plain_all``, else the shard
    from which the global-rank cut drops the most rows below the cap), the
    launch times, and the checked shard's pair counts and bound."""
    cap = sw.config.p3m_cell_capacity
    shards = shard_cells(pp, p3m_forces, sw)
    pick = max(range(len(shards)), key=lambda k: (shards[k][2], k))
    kw = {"cap_t": cap, "cap_s": cap}
    out = {"shard": pick, "launch_ms": []}
    for k, (cells, rc, dropped) in enumerate(shards):
        ms = cuda_ms(lambda: pp.pp_cells(*cells, rc, 4.0, **kw), reps=20)
        out["launch_ms"].append(ms)
        log(f"  {label} shard {k}: {cells[0].shape[0]} target rows, "
            f"{int(cells[3].clamp(max=cap).sum())} live, {dropped} more "
            f"below the cap dropped by the global-rank cut; K4 {ms:.4f} ms")
        if not (plain_all or k == pick):
            continue
        got = pp.pp_cells(*cells, rc, 4.0, **kw)
        t0 = time.perf_counter()
        want = pp.pp_cells_plain(*cells, rc, 4.0, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(f"{label} shard {k} K4 vs plain", rel(got, want), BOUND_PP)
        idx, live = pp.run_slots(cells[2], cells[3], cap, cells[0].shape[0])
        kept = torch.zeros(cells[0].shape[0], dtype=torch.bool,
                           device=got.device)
        kept[idx[live]] = True
        if not torch.equal(got[~kept], torch.zeros_like(got[~kept])):
            raise SystemExit(f"chip_smoke: {label} shard {k}: a row past "
                             "its cut count is not 0")
        if k == pick:
            c = pair_counts(compact_cut(pp, cells, cap), rc, cap)
            out.update(max_abs_err=float((got - want).abs().max()),
                       ms=ms, plain_ms=plain_ms, counts=c)
            out["bound_ms"], out["bound_by"] = pp_bound(c)
        del got, want
    log(f"  {label}: shard {pick} (the most rows cut) against its plain "
        f"version: K4 {out['ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}, {out['bound_ms'] / out['ms']:.1%} of it), "
        f"plain {out['plain_ms']:.3f} ms; {out['counts']['candidates']:.4e} "
        f"candidate pairs, {out['counts']['inside']:.4e} inside rc")
    return out


def run_mesh(df, pp, sw, label: str) -> dict:
    """The sharded main path: a warm-up substep, then MESH_TIMED timed
    substeps of dt 1.0 ([8]'s) with the launch counts from 0 and host
    syncs turned into errors; "p3m" must launch K4 once a shard and
    force_acc once a shard that holds sources, each substep."""
    sw.update(1.0, 1)
    sw.block_until_ready()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    df.LAUNCHES = pp.LAUNCHES = 0
    t0 = time.perf_counter()
    with no_sync():
        start.record()
        sw.update(1.0, MESH_TIMED)
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = {"pp": pp.LAUNCHES, "force_acc": df.LAUNCHES}
    with_src = sum(r > 0 for r in sw._src_rows)
    want = ({"pp": sw.n_devices * MESH_TIMED, "force_acc": with_src * MESH_TIMED}
            if sw.force_backend == "p3m" else {"pp": 0, "force_acc": 0})
    expect_launches(label, launches, want)
    finite_state(sw, label)
    ms = start.elapsed_time(end) / MESH_TIMED
    log(f"  {label}: {ms:.4f} ms/substep device, host "
        f"{enqueue_ms / MESH_TIMED:.4f} ms/substep to enqueue and "
        f"{host_ms / MESH_TIMED:.4f} to finish; launches K4 {launches['pp']}, "
        f"force_acc {launches['force_acc']} ({with_src} shards hold sources); "
        f"no host sync")
    return {"ms": ms, "launches": launches, "enqueue_ms": enqueue_ms / MESH_TIMED,
            "host_ms": host_ms / MESH_TIMED}


def phase_mesh(nt, sh, df, pp, p3m_forces, world_mod, scene_bench, scene_big,
               device) -> dict:
    """[18]: ShardedWorld "pm", "p3m" and "auto" with D shards on one card."""
    from nbody_tpu_torch import autodiff

    log(f"[18] the sharded mesh solvers on one card: D={MESH_SHARDS}, "
        f"N={BIG_N} slice {P3M_SIZED} and N={BENCH_N} default {P3M_DEFAULT}")
    t_phase = time.perf_counter()
    out = {}
    # a. "auto" by the per-chip rule and the crossover's number. The
    # answers are written out: D shards on one card are one chip, so
    # N=262144 (3.4e10 pairs, 8.6e9 a shard) at D=4 on this card is "p3m".
    limit = world_mod.AUTO_P3M_MIN_PAIRS
    bench_ml = int((scene_bench.mass > 0).sum())
    big_ml = int((scene_big.mass > 0).sum())
    for n, ml, d, want in ((BENCH_N, bench_ml, 1, "cuda"),
                           (BENCH_N, bench_ml, MESH_SHARDS, "cuda"),
                           (262144, 131072, MESH_SHARDS, "p3m"),
                           (BIG_N, big_ml, 1, "p3m"),
                           (BIG_N, big_ml, MESH_SHARDS, "p3m")):
        mesh = sh.make_mesh(devices=[device] * d)
        got = sh.resolve_force_backend("auto", mesh, n, ml)
        chips = sh.mesh_chips(mesh)
        log(f"  auto: N={n} mass_len={ml} D={d} shards on {chips} card(s): "
            f"{n * ml // chips:.4e} pairs a chip ({n * ml // d:.4e} a shard) "
            f"against AUTO_P3M_MIN_PAIRS {limit:.4e} -> {got!r}")
        if got != want:
            raise SystemExit(f"chip_smoke: auto resolved to {got!r}, not "
                             f"{want!r}")
    sw = mesh_world(nt, sh, scene_bench, {}, "auto", MESH_SHARDS, device)
    if sw.force_backend != "cuda":
        raise SystemExit(f"chip_smoke: ShardedWorld('auto') at N={BENCH_N} "
                         f"D={MESH_SHARDS} runs {sw.force_backend!r}, not "
                         f"'cuda'")
    del sw

    # b. against the World, over the seeds, each reading logged
    readings = {}
    repeat = {}
    for backend, n, cfg in (("p3m", BIG_N, P3M_SIZED), ("pm", BIG_N, P3M_SIZED),
                            ("p3m", BENCH_N, P3M_DEFAULT)):
        base = scene_big if n == BIG_N else scene_bench
        worst = {f: 0.0 for f in ("pos", "vel", "acc")}
        for seed in MESH_SEEDS:
            scene = base if seed == SEED else nt.make_galaxies(n, 2, seed=seed)
            gaps, parts = mesh_gaps(nt, sh, scene, cfg, backend, device)
            if seed == SEED:
                repeat[(backend, n)] = parts
            log(f"  {backend} N={n} D={MESH_SHARDS} vs World, seed {seed}, "
                f"{MESH_SUBSTEPS} substeps of {MESH_DT}: " + ", ".join(
                    f"{f} {v:.3e}" for f, v in gaps.items()))
            worst = {f: max(worst[f], gaps[f]) for f in worst}
        readings[(backend, n)] = worst
        bounds = MESH_VS_WORLD[(backend, n)]
        for f, v in worst.items():
            check(f"{backend} N={n} D={MESH_SHARDS} vs World over "
                  f"{len(MESH_SEEDS)} seeds, largest {f}", v, bounds[f])
    out["readings"] = readings

    # c. two runs bit-equal; D=1 bit-equal to the World
    for (backend, n), first in repeat.items():
        cfg = P3M_SIZED if n == BIG_N else P3M_DEFAULT
        base = scene_big if n == BIG_N else scene_bench
        sw = mesh_world(nt, sh, base, cfg, backend, MESH_SHARDS, device)
        sw.update(MESH_DT, MESH_SUBSTEPS)
        again = sw.particles
        same = all(torch.equal(getattr(first, f), getattr(again, f))
                   for f in ("pos", "vel", "acc"))
        log(f"  {backend} N={n} D={MESH_SHARDS}, run twice: bit-equal {same}")
        if not same:
            raise SystemExit(f"chip_smoke: two sharded {backend} runs differ")
    for backend in ("p3m", "pm"):
        w = nt.create_world(scene_big, config=nt.SimConfig(**P3M_SIZED),
                            device=device)
        sw = mesh_world(nt, sh, scene_big, P3M_SIZED, backend, 1, device)
        w.update(MESH_DT, MESH_SUBSTEPS, backend=backend)
        sw.update(MESH_DT, MESH_SUBSTEPS)
        same = {f: torch.equal(getattr(sw.particles, f),
                               getattr(w.particles, f))
                for f in ("pos", "vel", "acc")}
        log(f"  {backend} N={BIG_N} D=1 vs World, {MESH_SUBSTEPS} substeps: "
            f"bit-equal {same}")
        if not all(same.values()):
            raise SystemExit(f"chip_smoke: sharded {backend} D=1 differs from "
                             "the World")
        del w, sw

    # d. the main path: timed, exact launches, no host sync; K4 on shards
    for key, n, cfg, scene in (("slice", BIG_N, P3M_SIZED, scene_big),
                               ("default", BENCH_N, P3M_DEFAULT, scene_bench)):
        sw = mesh_world(nt, sh, scene, cfg, "p3m", MESH_SHARDS, device)
        # K4 on each shard at the scene's state, the main path's first
        # launches ([6] takes the World's there too)
        k4 = shard_k4(pp, p3m_forces, sw, f"p3m N={n} D={MESH_SHARDS}",
                      plain_all=n == BENCH_N)
        run = run_mesh(df, pp, sw, f"sharded p3m N={n} D={MESH_SHARDS} {cfg}")
        run["k4"] = k4
        out[key] = run
        if key == "slice":
            prof = profile_stages(sw, 3, stages=MESH_STAGES)
            log(f"  profiler over 3 sharded substeps: device busy "
                f"{prof['busy_ms']:.4f} ms of {prof['wall_ms']:.4f} ms wall "
                f"per substep, idle {prof['idle']:.2%}. Per substep by stage, "
                f"device ms (share of busy) and host ms (shards.sum also "
                f"inside p3m.exact_rows):")
            for name, ms in prof["stages"].items():
                log(f"    {name:18s} device {ms:9.4f} ms "
                    f"{ms / prof['busy_ms']:6.1%}   host "
                    f"{prof['host'][name]:8.4f} ms")
            run["profile"] = prof
        del sw
    spm = mesh_world(nt, sh, scene_big, P3M_SIZED, "pm", MESH_SHARDS, device)
    out["pm"] = run_mesh(df, pp, spm, f"sharded pm N={BIG_N} D={MESH_SHARDS}")
    # in turns with the World's p3m: World, p3m, pm, pm, p3m, World
    w = nt.create_world(scene_big, config=nt.SimConfig(**P3M_SIZED),
                        device=device)
    w.update(1.0, 1, backend="p3m")
    sp3 = mesh_world(nt, sh, scene_big, P3M_SIZED, "p3m", MESH_SHARDS, device)
    sp3.update(1.0, 1)
    turns = {"World p3m": [], "sharded p3m": [], "sharded pm": []}
    for name in ("World p3m", "sharded p3m", "sharded pm", "sharded pm",
                 "sharded p3m", "World p3m"):
        fn = {"World p3m": lambda: w.update(1.0, MESH_TIMED, backend="p3m"),
              "sharded p3m": lambda: sp3.update(1.0, MESH_TIMED),
              "sharded pm": lambda: spm.update(1.0, MESH_TIMED)}[name]
        dev, host, _ = timed(fn)
        turns[name].append((dev / MESH_TIMED, host / MESH_TIMED))
    for name, got in turns.items():
        log(f"  {name} N={BIG_N} slice, in turns: device " + ", ".join(
            f"{d:.4f}" for d, _ in got) + " ms/substep; host " + ", ".join(
            f"{h:.4f}" for _, h in got))
    out["turns"] = turns
    del w, sp3, spm

    # e. rollout_sharded "p3m", D shards, N=65536 default config
    cfg = nt.SimConfig(**P3M_DEFAULT)
    w = nt.create_world(scene_bench, config=cfg, device=device)
    st, ml = w.state, w.mass_len
    tracer = ml
    target = st.pos[tracer] + 5.0
    kw = dict(n_steps=AD_P3M_SHARDED_STEPS, mass_len=ml, backend="p3m",
              precise=cfg.precise, g=cfg.g, pm_grid=cfg.pm_grid,
              pm_softening=cfg.pm_softening, p3m_rc_cells=cfg.p3m_rc_cells,
              p3m_cell_capacity=cfg.p3m_cell_capacity,
              p3m_exact_targets=cfg.p3m_exact_targets)
    mesh = sh.make_mesh(devices=[device] * MESH_SHARDS)

    def run_ad(sharded, steps=AD_P3M_SHARDED_STEPS):
        p = st.pos.detach().clone().requires_grad_()
        kws = dict(kw, n_steps=steps)
        if sharded:
            fin, _ = autodiff.rollout_sharded(p, st.vel, st.mass, st.radius,
                                              AD_DT, mesh=mesh, **kws)
        else:
            fin, _ = autodiff.rollout(p, st.vel, st.mass, st.radius, AD_DT,
                                      **kws)
        loss = torch.sum((fin[tracer] - target) ** 2)
        return fin.detach(), loss.detach(), torch.autograd.grad(loss, p)[0]

    df.LAUNCHES = df.VJP_LAUNCHES = pp.LAUNCHES = pp.VJP_LAUNCHES = 0
    with no_sync():
        fin_s, v_s, g_s = run_ad(True)
    torch.cuda.synchronize()
    counts = {"K4": pp.LAUNCHES, "K4 VJP": pp.VJP_LAUNCHES}
    # forward and recomputed under remat: D launches an evaluation each
    expect_launches(f"rollout_sharded p3m N={BENCH_N} D={MESH_SHARDS}", counts,
                    {"K4": 2 * MESH_SHARDS * AD_P3M_SHARDED_STEPS,
                     "K4 VJP": MESH_SHARDS * AD_P3M_SHARDED_STEPS})
    _, _, g_again = run_ad(True)
    if not torch.equal(g_s, g_again) or not torch.isfinite(g_s).all():
        raise SystemExit("chip_smoke: rollout_sharded p3m gradient not finite "
                         "or not bit-equal twice")
    w.update(AD_DT, AD_P3M_SHARDED_STEPS, backend="p3m")
    check(f"rollout_sharded p3m D={MESH_SHARDS} N={BENCH_N} vs World.update, "
          f"pos", rel(fin_s, w.state.pos), AD_VALUE)
    _, v_1, g_1 = run_ad(False)
    check(f"rollout_sharded p3m D={MESH_SHARDS} N={BENCH_N} tracer loss vs "
          f"single device", float((v_s - v_1).abs() / v_1.abs()),
          AD_SHARD_VALUE)
    check(f"rollout_sharded p3m D={MESH_SHARDS} N={BENCH_N} gradient vs "
          f"single device", rel(g_s, g_1), AD_SHARD_GRAD)
    ad_ms = timed(lambda: run_ad(True))[0] / AD_P3M_SHARDED_STEPS
    log(f"  rollout_sharded 'p3m' D={MESH_SHARDS} N={BENCH_N}, "
        f"{AD_P3M_SHARDED_STEPS} steps: launches {counts}; no host sync; "
        f"gradient bit-equal twice; forward and backward {ad_ms:.4f} ms/step")
    out["rollout_ms"] = ad_ms
    del w
    log(f"  [18] took {time.perf_counter() - t_phase:.1f} s")
    return out


# [19] the device-side scenes: the four generators at full size on the
# card, K1 with every row a source, the physics checks of the JAX suite's
# scene tests (each gated at that test's own size and bound, read at
# BENCH_N), the native AVX oracle as a third judge of K1, the device
# galaxies through the p3m slice, and the CLI's --scene.
SCENE_DT = 0.005                # tests/test_plummer.py's substep
SCENE_SUBSTEPS = 10
ORACLE_BOUND = BOUND_SMALL      # acc, vel and pos, one substep at N=65536
ORACLE_SMALL_N = 8192           # the Plummer scene, tests/test_cpp_oracle.py:33-46
ORACLE_SMALL_STEPS = 10
ORACLE_RTOL, ORACLE_ATOL = 5e-4, 5e-2
# tests/test_disks.py: (N, substeps, dt) of the Kepler and cold-disk cases
KEPLER_CASE = (128, 300, 0.001)
COLD_CASE = (256, 50, 0.01)
ADAPTIVE_CASE = (128, 0.5, 0.05)  # N, t_span, dt_max
ADAPTIVE_READING_SPAN = 0.02      # the reading at BENCH_N (the collapse's
                                  # substeps grow with N)
SCENE_P3M_SUBSTEPS = 3
CLI_SCENE_STEPS = 3


def gate(what: str, value: float, bound: float) -> None:
    """Fail unless value < bound (a negated pair gates value > bound)."""
    ok = np.isfinite(value) and value < bound
    log(f"  {what}: {abs(value):.4g} ({'<' if bound > 0 else '>'} "
        f"{abs(bound):g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {what} out of bound")


def check_structure(nt, name: str, p, n: int, device) -> dict:
    """The structural checks of the CPU tests (tests/test_torch_scenes.py)
    on a scene drawn on the card."""
    fields = {f: getattr(p, f) for f in ("pos", "vel", "acc", "mass", "radius")}
    for f, x in fields.items():
        if x.device.type != device.type or x.dtype != torch.float32 \
                or x.shape[0] != n or not torch.isfinite(x).all():
            raise SystemExit(f"chip_smoke: {name}.{f} is not {n} finite fp32 "
                             "rows on the card")
    pos, vel = p.pos.double(), p.vel.double()
    mass, radius = p.mass.double(), p.radius.double()
    r = torch.hypot(pos[:, 0], pos[:, 1])
    out = {"mass_len": int((p.mass > 0).sum())}
    fails = []
    if name == "galaxies":
        cfg = nt.GalaxyConfig()
        core = mass >= cfg.min_gc_mass
        tracer = mass == 0
        body = ~core & ~tracer
        cores = torch.nonzero(core).reshape(-1)
        rc, rb = radius[core], radius[body]
        ratio_c = mass[core] / cfg.r_to_m(rc, cfg.gc_density)
        ratio_b = mass[body] / cfg.r_to_m(rb, cfg.np_density)
        # each row's galaxy: the rows from a core to the next are its own
        gal = torch.searchsorted(cores, torch.arange(n, device=cores.device),
                                 right=True) - 1
        d = torch.hypot(*(pos - pos[cores][gal]).T)
        speed = torch.hypot(*(vel - vel[cores][gal]).T)
        orbit = ~core
        want = torch.sqrt(nt.G * mass[cores][gal][orbit] / d[orbit])
        speed_err = float(((speed[orbit] - want).abs() / want).max())
        norm = d[orbit] / radius[cores][gal][orbit]
        med = norm.median()
        t = tracer[orbit]
        inner, outer = float(t[norm <= med].double().mean()), \
            float(t[norm > med].double().mean())
        out.update(cores=len(cores), tracers=float(tracer.double().mean()),
                   speed_err=speed_err, inner=inner, outer=outer)
        checks = {"two cores": len(cores) == 2,
                  "core radii in [200, 600)": bool(((rc >= 200) & (rc < 600)).all()),
                  "body radii in [1.5, 9.5]": bool(((rb >= 1.5) & (rb <= 9.5)).all()),
                  "tracers: mass 0, radius 0.5": bool(tracer.any()) and bool(
                      (radius[tracer] == 0.5).all()),
                  "core mass / r^3 at density 30": float(
                      (ratio_c - 1).abs().max()) < 1e-4,
                  "body mass / r^3 at density 10": float(
                      (ratio_b - 1).abs().max()) < 1e-4,
                  "circular speed about the core (rtol 1e-3)": speed_err < 1e-3,
                  "tracer share rises with distance": outer > inner + 0.1}
    else:
        checks = {"mass_len == N": out["mass_len"] == n}
        if name == "plummer":
            v = torch.hypot(vel[:, 0], vel[:, 1])
            cosang = float(((vel * pos).sum(1).abs()
                            / torch.clamp(v * r, min=1e-9)).mean())
            out.update(r50=float(r.median()), cosang=cosang)
            checks["median radius 400 (rtol 0.1)"] = abs(out["r50"] - 400) < 40
            checks["mostly tangential (mean cos < 0.1)"] = cosang < 0.1
        elif name == "kepler":
            v = torch.hypot(vel[1:, 0], vel[1:, 1])
            want = torch.sqrt(nt.G * 1e7 / r[1:])
            out["speed_err"] = float(((v - want).abs() / want).max())
            checks["central mass 1e7, bodies 1"] = float(mass[0]) == 1e7 and \
                bool((mass[1:] == 1).all())
            checks["radii in [200, 1200]"] = float(r[1:].min()) >= 200 - 1e-3 \
                and float(r[1:].max()) <= 1200 + 1e-3
            checks["circular speed (rtol 1e-5)"] = out["speed_err"] < 1e-5
        else:
            checks["at rest"] = bool((p.vel == 0).all())
            checks["inside the extent 800"] = float(r.max()) <= 800 * (1 + 1e-6)
    for what, ok in checks.items():
        if not ok:
            fails.append(what)
    log(f"  {name}: {n} rows, mass_len {out['mass_len']}; checks "
        + ", ".join(checks) + (" ok" if not fails else f" FAILED: {fails}"))
    if fails:
        raise SystemExit(f"chip_smoke: the {name} scene on the card: {fails}")
    return out


def draw_scenes(nt, models, profiling, host_gen_s: float, smi: str,
                device) -> dict:
    """[19a]: each generator twice from one seed on the card, with host
    syncs turned into errors: bit-equal, structurally right, timed (the
    wall time through utils.profiling.StepTimer, the device time by CUDA
    events)."""
    log(f"[19a] the device-side scenes at full size on the card, seed {SEED}")
    out = {}
    makers = {"galaxies": (models.make_galaxies_device, (BIG_N, 2)),
              "plummer": (models.make_plummer_disk, (BENCH_N,)),
              "kepler": (models.make_kepler_disk, (BENCH_N,)),
              "cold": (models.make_cold_disk, (BENCH_N,))}
    for name, (make, args) in makers.items():
        timer, runs, dev = profiling.StepTimer(), [], []
        for _ in range(2):
            box = []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            with timer.measure(box):
                with no_sync():
                    start.record()
                    box.append(make(SEED, *args, device=device))
                    end.record()
            dev.append(start.elapsed_time(end))
            runs.append(box[0])
        same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
                   for f in ("pos", "vel", "acc", "mass", "radius"))
        log(f"  {name}{args}: twice from seed {SEED} with no host sync, "
            f"bit-equal {same}")
        if not same:
            raise SystemExit(f"chip_smoke: two {name} scenes of one seed differ")
        stats = check_structure(nt, name, runs[0], args[0], device)
        log(f"  {name}: wall {timer.summary()} (StepTimer, to the card's "
            f"last op), device {dev[0]:.4f} and {dev[1]:.4f} ms [{smi}]")
        out[name] = {"scene": runs[0], "wall_us": timer.best_us,
                     "device_ms": min(dev), **stats}
    g = out["galaxies"]
    log(f"  galaxies: {g['tracers']:.2%} tracers; tracer share {g['inner']:.3f} "
        f"inside the median distance, {g['outer']:.3f} outside; speed about "
        f"the core within {g['speed_err']:.2e}")
    log(f"  host numpy make_galaxies({BIG_N}, 2): {host_gen_s * 1e3:.1f} ms "
        f"against the card's {g['wall_us'] / 1e3:.4f} ms wall, "
        f"{g['device_ms']:.4f} ms device [{smi}]")
    return out


def all_massive_k1(nt, df, plummer, smi: str, device) -> dict:
    """[19b]: the Plummer scene in World "cuda" (S = N): K1 against its
    plain version, then SCENE_SUBSTEPS timed substeps, exact launches, no
    host sync; the plain "torch" backend timed beside it."""
    log(f"[19b] K1 with every row a source: the Plummer scene, N={BENCH_N}")
    world = nt.create_world(plummer, device=device)
    n, s = world.total_len, world.mass_len
    if s != n:
        raise SystemExit(f"chip_smoke: the Plummer World has mass_len {s} != {n}")
    st = world.state
    df.PLANS.clear()
    err = compare_variants(df, f"Plummer N={n} S={s}", st.pos, st.vel,
                           st.radius, world.gm, BOUND_SMALL)
    log_plans("Plummer", df.PLANS)
    world.update(SCENE_DT, 1)
    world.block_until_ready()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    df.LAUNCHES = 0
    with no_sync():
        start.record()
        world.update(SCENE_DT, SCENE_SUBSTEPS)
        end.record()
    torch.cuda.synchronize()
    launches = df.LAUNCHES
    expect_launches(f"the Plummer World, {SCENE_SUBSTEPS} substeps", launches,
                    SCENE_SUBSTEPS)
    finite_state(world, "the Plummer World")
    ms = start.elapsed_time(end) / SCENE_SUBSTEPS
    plain = nt.create_world(plummer, device=device)
    plain.update(SCENE_DT, 1, backend="torch")
    plain_ms = cuda_ms(lambda: plain.update(SCENE_DT, 1, backend="torch"),
                       reps=2)
    b_ms, b_by = bound(FLOPS_DIRECT * n * s, 44 * n + 4 * s, MUFU_DIRECT * n * s)
    log(f"  fused substep S = N = {n}: {ms:.4f} ms/substep, "
        f"{n * s / (ms * 1e-3):.4e} pairs/s, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.1%} of it); plain {plain_ms:.4f} ms; launches "
        f"{launches}, no host sync [{smi}]")
    return {"n": n, "s": s, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def kepler_radii(nt, models, n: int, steps: int, dt: float, device) -> float:
    """max relative change of the bodies' orbit radii after ``steps``
    substeps of the Kepler disk (tests/test_disks.py:28-38)."""
    gen = torch.Generator(device=device).manual_seed(1)
    w = nt.create_world(models.make_kepler_disk(gen, n), device=device)
    r0 = torch.hypot(*w.state.pos[1:].T)
    w.update(dt, steps)
    r1 = torch.hypot(*w.state.pos[1:].T)
    return float(((r1 - r0).abs() / r0).max())


def cold_collapse(nt, models, n: int, steps: int, dt: float, device) -> dict:
    """Momentum over its scale, radial velocities and kinetic energy after
    ``steps`` substeps of the cold disk (tests/test_disks.py:41-59)."""
    gen = torch.Generator(device=device).manual_seed(2)
    w = nt.create_world(models.make_cold_disk(gen, n), device=device)
    w.update(dt, steps)
    p = w.particles
    mass, pos, vel = (x.double() for x in (p.mass, p.pos, p.vel))
    mom = (mass[:, None] * vel).sum(0)
    v_rad = (pos * vel).sum(1) / torch.clamp(torch.hypot(*pos.T), min=1e-6)
    return {"mom": float(mom.abs().max() / (mass[:, None] * vel).abs().sum()),
            "v_mean": float(v_rad.mean()), "v_median": float(v_rad.median()),
            "kinetic": float(0.5 * (mass * (vel ** 2).sum(1)).sum()),
            "finite": bool(torch.isfinite(p.pos).all())}


def scene_physics(nt, df, models, smi: str, device) -> dict:
    """[19b] the physics checks of tests/test_disks.py on World "cuda":
    each gated at the JAX test's own size and bound, and read at BENCH_N
    (a bound set at N=128-256 is not carried to N=65536)."""
    n, steps, dt = KEPLER_CASE
    err = kepler_radii(nt, models, n, steps, dt, device)
    gate(f"Kepler N={n}, {steps} substeps of {dt}: max relative change of "
         f"the orbit radii", err, 1e-2)
    big = kepler_radii(nt, models, BENCH_N, steps, dt, device)
    log(f"  reading: Kepler N={BENCH_N}, {steps} substeps of {dt}: orbit "
        f"radii within {big:.3e} (relative) [{smi}]")
    n, steps, dt = COLD_CASE
    c = cold_collapse(nt, models, n, steps, dt, device)
    gate(f"cold disk N={n}, {steps} substeps of {dt}: |momentum| / scale",
         c["mom"], 1e-5)
    log(f"  cold disk N={n}: radial velocity mean {c['v_mean']:.4f}, median "
        f"{c['v_median']:.4f}, kinetic energy {c['kinetic']:.4e}")
    if not (c["finite"] and c["v_median"] < -1.0 and c["kinetic"] > 0):
        raise SystemExit("chip_smoke: the cold disk does not fall inward")
    cb = cold_collapse(nt, models, BENCH_N, steps, dt, device)
    log(f"  reading: cold disk N={BENCH_N}: |momentum| / scale "
        f"{cb['mom']:.3e}, radial velocity mean {cb['v_mean']:.4f}, median "
        f"{cb['v_median']:.4f} [{smi}]")
    n, span, dt_max = ADAPTIVE_CASE
    out = {}
    for size, t_span in ((n, span), (BENCH_N, ADAPTIVE_READING_SPAN)):
        gen = torch.Generator(device=device).manual_seed(3)
        w = nt.create_world(models.make_cold_disk(gen, size), device=device)
        df.LAUNCHES = 0
        dev_ms, host_ms, k = timed(lambda: w.update_adaptive(t_span,
                                                             dt_max=dt_max))
        out[size] = {"k": k, "launches": df.LAUNCHES, "ms": dev_ms / k}
        log(f"  {'reading: ' if size != n else ''}cold disk N={size} "
            f"update_adaptive({t_span}, dt_max={dt_max}) on 'cuda': {k} "
            f"substeps, {df.LAUNCHES} force_acc launches, {dev_ms / k:.4f} ms "
            f"a substep on the device, {host_ms / k:.4f} on the host [{smi}]")
    for size, r in out.items():
        expect_launches(f"cold disk N={size} update_adaptive", r["launches"],
                        adaptive_evaluations(r["k"]))
    gate(f"cold disk N={n}: adaptive substeps over span / dt_max + 1",
         -out[n]["k"], -(int(span / dt_max) + 1))
    return {"kepler": big, "cold": cb, "adaptive": out}


def oracle_judges(nt, models, cpp_oracle, scene_bench, smi: str, device) -> dict:
    """[19c]: the native AVX oracle (cpp/nbody_oracle.cpp, IEEE sqrt) and
    World "cuda" (precise) from the same massive-first state."""
    log("[19c] the AVX oracle against the card's K1 (precise)")
    out = {}
    w = nt.create_world(scene_bench, config=nt.SimConfig(precise=True),
                        device=device)
    host = w.particles
    t0 = time.perf_counter()
    try:
        want = cpp_oracle.oracle_update(host, w.mass_len, 0.01, 1)
    except cpp_oracle.OracleUnavailable as e:
        raise SystemExit(f"chip_smoke: the AVX oracle: {e}") from e
    out["oracle_s"] = time.perf_counter() - t0
    w.update(0.01, 1)
    got = w.particles
    for f in ("acc", "vel", "pos"):
        out[f] = rel(getattr(got, f), getattr(want, f))
        check(f"two galaxies N={BENCH_N} S={w.mass_len}, 1 substep of 0.01: "
              f"{f} against the oracle", out[f], ORACLE_BOUND)
    log(f"  the oracle's substep: {out['oracle_s']:.2f} s on the host "
        f"[{smi}]")
    gen = torch.Generator(device=device).manual_seed(SEED)
    w = nt.create_world(models.make_plummer_disk(gen, ORACLE_SMALL_N),
                        config=nt.SimConfig(precise=True), device=device)
    want = cpp_oracle.oracle_update(w.particles, w.mass_len, 0.01,
                                    ORACLE_SMALL_STEPS)
    w.update(0.01, ORACLE_SMALL_STEPS)
    got = w.particles
    for f in ("pos", "vel"):
        a, b = getattr(got, f).double(), getattr(want, f).double()
        excess = float(((a - b).abs() - ORACLE_RTOL * b.abs()).max())
        log(f"  Plummer N={ORACLE_SMALL_N}, {ORACLE_SMALL_STEPS} substeps: "
            f"{f} max|d| - {ORACLE_RTOL:g}|ref| = {excess:.3e} (bound "
            f"{ORACLE_ATOL:g}); max|d|/max|ref| {rel(a, b):.3e}")
        if not excess <= ORACLE_ATOL:
            raise SystemExit(f"chip_smoke: Plummer {f} against the oracle "
                             "out of bound")
    return out


def device_galaxies_p3m(nt, df, pp, p3m_forces, galaxies, smi: str,
                        device) -> dict:
    """[19d]: make_galaxies_device(SEED, BIG_N, 2) on "p3m" with the
    slice's config: K4 on its cells (rsqrt) and the exact-core force_acc
    against their plain versions ([6]'s and [7]'s bounds),
    SCENE_P3M_SUBSTEPS substeps with exact launches and no host sync, and,
    as readings beside [9]'s bounds (set on the other scene), the cell
    overflow and the force error against the direct kernel on SUBSET fixed
    targets at the initial state; then a profiler window split by the p3m
    stages."""
    log(f"[19d] the device galaxies through the p3m slice {P3M_SIZED}")
    w = nt.create_world(galaxies, config=nt.SimConfig(**P3M_SIZED),
                        device=device)
    cfg, st, s = w.config, w.state, w.mass_len
    cap = cfg.p3m_cell_capacity
    bins, trows, srows, rc = world_bins(pp, p3m_forces, w)
    cells = [trows, srows, bins["start_t"], bins["counts_t"], bins["start_s"],
             bins["counts_s"]]
    out = {"s": s}
    # the main path's rsqrt form only: the plain version takes ~30 s here
    # ([6] holds both forms on the host scene's cells)
    got = pp.pp_cells(*cells, rc, 4.0, cap_t=cap, cap_s=cap)
    want = pp.pp_cells_plain(*cells, rc, 4.0, cap_t=cap, cap_s=cap)
    check(f"K4 cells route rsqrt, N={w.total_len} S={s}", rel(got, want),
          BOUND_PP)
    del got, want
    out["k4_ms"] = cuda_ms(lambda: pp.pp_cells(*cells, rc, 4.0, cap_t=cap,
                                               cap_s=cap), reps=5)
    rows = p3m_forces.exact_core_rows(st.radius, cfg.p3m_exact_targets)
    tp, tr = st.pos[rows].contiguous(), st.radius[rows].contiguous()
    for precise in (False, True):
        check(f"exact-core force_acc T={tp.shape[0]} S={s} "
              f"{'precise' if precise else 'rsqrt'}",
              rel(df.force_acc(tp, tr, st.pos[:s], w.gm, precise=precise),
                  df.force_acc_plain(tp, tr, st.pos[:s], w.gm, precise=precise)),
              BOUND_SPLIT_BIG)
    del cells, trows, srows, bins
    kw = dict(grid=cfg.pm_grid, cell_capacity=cap)
    out["overflow"] = int(nt.p3m_cell_overflow(st.pos[:s], w.gm, **kw))
    got = nt.p3m_acc(st.pos, st.radius, st.pos[:s], w.gm, 2.0, **kw)
    rows = torch.from_numpy(np.random.default_rng(3).choice(
        w.total_len, SUBSET, replace=False)).to(device)
    ref = df.force_acc(st.pos[rows], st.radius[rows], st.pos[:s], w.gm,
                       precise=True)
    err = p3m_errors(got[rows], ref)
    del got
    out["err"] = {"median": float(np.median(err)),
                  "p99": float(np.percentile(err, 99)), "max": float(err.max())}
    log(f"  reading at the initial state: p3m_cell_overflow {out['overflow']} "
        f"of {s} sources ({out['overflow'] / s:.2%}); per-target error "
        f"against the direct kernel on {SUBSET} targets: median "
        f"{out['err']['median']:.3e} ([9]'s bound {P3M_MEDIAN:g}), p99 "
        f"{out['err']['p99']:.3e} ({P3M_P99:g}), max {out['err']['max']:.3e}")
    w.update(1.0, 1, backend="p3m")
    w.block_until_ready()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    df.LAUNCHES = pp.LAUNCHES = 0
    with no_sync():
        start.record()
        w.update(1.0, SCENE_P3M_SUBSTEPS, backend="p3m")
        end.record()
    torch.cuda.synchronize()
    expect_launches("device galaxies p3m, K4", pp.LAUNCHES, SCENE_P3M_SUBSTEPS)
    expect_launches("device galaxies p3m, force_acc", df.LAUNCHES,
                    SCENE_P3M_SUBSTEPS)
    finite_state(w, "the device galaxies on p3m")
    out["ms"] = start.elapsed_time(end) / SCENE_P3M_SUBSTEPS
    log(f"  p3m substep {out['ms']:.4f} ms (CUDA events), K4 "
        f"{out['k4_ms']:.4f} ms at the initial state; launches exact, no "
        f"host sync [{smi}]")
    prof = profile_stages(w)
    log(f"  profiler over 3 more substeps: device busy {prof['busy_ms']:.4f} "
        f"ms of {prof['wall_ms']:.4f} ms wall a substep, idle "
        f"{prof['idle']:.2%}; device ms a substep by stage: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in prof["stages"].items()))
    out["profile"] = prof
    return out


def scene_cli(smi: str) -> list:
    """[19e]: run --scene plummer|kepler|cold at N=BENCH_N on "cuda" as a
    user runs it; each saved state must hold N rows."""
    log("[19e] the CLI's device-side scenes")
    out_dir = ROOT / "build" / "chip_smoke_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    secs = []
    for scene in ("plummer", "kepler", "cold"):
        path = out_dir / f"scene_{scene}.npz"
        secs.append(run_cli(["run", "--scene", scene, "--n", str(BENCH_N),
                             "--backend", "cuda", "--steps",
                             str(CLI_SCENE_STEPS), "--save", str(path)]))
        with np.load(path) as d:
            ok = (d["pos"].shape == (BENCH_N, 2) and int(d["step"]) ==
                  CLI_SCENE_STEPS and np.isfinite(d["pos"]).all())
        log(f"  {path.relative_to(ROOT)}: {BENCH_N} rows, step "
            f"{CLI_SCENE_STEPS}, finite: {ok}")
        if not ok:
            raise SystemExit(f"chip_smoke: run --scene {scene} saved a wrong "
                             "state")
    log(f"  wall s: {', '.join(f'{x:.1f}' for x in secs)} [{smi}]")
    return secs


def phase_scenes(nt, df, pp, p3m_forces, scene_bench, host_gen_s: float,
                 smi: str, device) -> dict:
    from nbody_tpu_torch import models
    from nbody_tpu_torch.utils import cpp_oracle, profiling

    t0 = t_step = time.perf_counter()

    def took(step: str) -> None:
        nonlocal t_step
        log(f"  [{step}] took {time.perf_counter() - t_step:.1f} s")
        t_step = time.perf_counter()

    scenes = draw_scenes(nt, models, profiling, host_gen_s, smi, device)
    took("19a")
    k1 = all_massive_k1(nt, df, scenes["plummer"]["scene"], smi, device)
    physics = scene_physics(nt, df, models, smi, device)
    took("19b")
    oracle = oracle_judges(nt, models, cpp_oracle, scene_bench, smi, device)
    took("19c")
    p3m = device_galaxies_p3m(nt, df, pp, p3m_forces,
                              scenes["galaxies"]["scene"], smi, device)
    del scenes["galaxies"]["scene"]
    took("19d")
    cli = scene_cli(smi)
    took("19e")
    log(f"  [19] took {time.perf_counter() - t0:.1f} s")
    return {"scenes": scenes, "k1": k1, "physics": physics, "oracle": oracle,
            "p3m": p3m, "cli": cli}


MH_SHARDS = 4
MH_DT = 0.01
MH_SUBSTEPS = 10
MH_SPAN = 0.02                  # the adaptive span after the fixed substeps
MH_TIMED = 10
MH_PLAIN_SUBSTEPS = 2
FIELDS = ("pos", "vel", "acc", "mass", "radius")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def same_bits(label: str, got, want) -> None:
    for f in FIELDS:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            d = (getattr(got, f) - getattr(want, f)).abs().max()
            raise SystemExit(f"chip_smoke: {label}: {f} not bit-equal "
                             f"(max |d| {float(d):.3e})")


def phase_multihost(nt, sh, df, rf, pp, p3m_forces, multihost, scene_bench,
                    scene_big, device) -> dict:
    """[20]: multihost_world over an NCCL group of one with D=4 shards on
    the card, against the single-process ShardedWorld."""
    import torch.distributed as dist

    log(f"[20] multi-process on the card: an NCCL group of world size 1, "
        f"D={MH_SHARDS} local shards on {device}, through multihost_world")
    t_phase = time.perf_counter()
    multihost.initialize(f"localhost:{free_port()}", 1, 0,
                         local_device_ids=[device.index or 0])
    out = {}
    try:
        backend = str(dist.get_backend())
        if backend != "nccl":
            raise SystemExit(f"chip_smoke: [20] the group runs {backend!r}, "
                             "not nccl")
        mesh = [device] * MH_SHARDS
        cases = (("ring", scene_bench, {}, "cuda_ring"),
                 ("p3m", scene_big, P3M_SIZED, "p3m"))
        for key, scene, cfg, backend in cases:
            label = f"[20] {backend} N={scene.pos.shape[0]}"
            config = nt.SimConfig(**cfg)
            mw = multihost.multihost_world(scene, mesh, config=config,
                                           force_backend=backend)
            sw = sh.ShardedWorld(scene, sh.make_mesh(devices=mesh),
                                 config=config, force_backend=backend)
            if mw.group.pg is None or mw.group.size != 1 \
                    or mw.n_devices != MH_SHARDS:
                raise SystemExit(f"chip_smoke: {label}: not a world over the "
                                 "group")
            # the main path's run, the counts from 0 just before it
            rf.LAUNCHES = pp.LAUNCHES = df.LAUNCHES = 0
            mw.update(MH_DT, MH_SUBSTEPS)
            mw.block_until_ready()
            got = {"K3": rf.LAUNCHES, "K4": pp.LAUNCHES,
                   "force_acc": df.LAUNCHES}
            if key == "ring":
                want = {"K3": MH_SHARDS ** 2 * MH_SUBSTEPS, "K4": 0,
                        "force_acc": 0}
            else:
                with_src = sum(r > 0 for r in mw._src_rows)
                want = {"K3": 0, "K4": MH_SHARDS * MH_SUBSTEPS,
                        "force_acc": with_src * MH_SUBSTEPS}
            expect_launches(label, got, want)
            sw.update(MH_DT, MH_SUBSTEPS)
            gathered = multihost.gather_particles(mw)
            same_bits(f"{label}: multihost_world against ShardedWorld",
                      gathered, sw.particles)
            same_bits(f"{label}: gather_particles against particles",
                      gathered, mw.particles)
            k_m = mw.update_adaptive(MH_SPAN, dt_max=MH_DT)
            k_s = sw.update_adaptive(MH_SPAN, dt_max=MH_DT)
            if k_m != k_s:
                raise SystemExit(f"chip_smoke: {label}: adaptive count {k_m} "
                                 f"over the group, {k_s} in one process")
            same_bits(f"{label}: after update_adaptive",
                      multihost.gather_particles(mw), sw.particles)
            finite_state(mw, label)
            log(f"  {label}: {MH_SUBSTEPS} substeps bit-equal to the "
                f"single-process world, launches {got}; update_adaptive "
                f"{k_m} substeps in both, bit-equal")
            res = {"launches": got, "k_adaptive": k_m, "mass_len": mw.mass_len,
                   "n_pad": mw.n_pad, "n": mw.total_len}
            if key == "ring":
                res["max_abs_err"] = hop_error(rf, mw)
                prof = profile_overlap(
                    mw, PROFILE_SUBSTEPS[BENCH_N], "ring_hop_kernel",
                    launches=MH_SHARDS ** 2,
                    launch_ms=lambda: cuda_ms(last_hop(rf, mw), reps=10))
                res["profile"] = prof
                # the window may hold fewer launches than ran (one has
                # kept 13 of the 16 a substep): the mean launch it saw,
                # times the D² launches a substep
                launch_ms = prof["kernel_sum_ms"] / prof["kernel_launches"]
                res["k3_ms"] = launch_ms * MH_SHARDS ** 2
                log(f"  {label} profiler: card busy {prof['busy_ms']:.4f} ms "
                    f"of {prof['wall_ms']:.4f} ms wall a substep (idle "
                    f"{prof['idle']:.2%}); ring_hop_kernel "
                    f"{prof['kernel_launches']:g} launches a substep in the "
                    f"window, {launch_ms:.4f} ms each: "
                    f"{res['k3_ms']:.4f} ms for the {MH_SHARDS ** 2} a "
                    "substep")
                plain = multihost.multihost_world(scene, mesh, config=config,
                                                  force_backend="torch")
                plain.update(1.0, 1)
                plain.block_until_ready()
                res["plain_ms"] = cuda_ms(lambda: plain.update(
                    1.0, MH_PLAIN_SUBSTEPS)) / MH_PLAIN_SUBSTEPS
                del plain
            else:
                res["k4"] = shard_k4(pp, p3m_forces, mw, label, plain_all=False)
            turns = {"multihost": [], "single": []}
            for name in ("multihost", "single", "single", "multihost"):
                w = mw if name == "multihost" else sw
                w.update(1.0, 1)
                dev_ms, host_ms, _ = timed(lambda: w.update(1.0, MH_TIMED))
                turns[name].append((dev_ms / MH_TIMED, host_ms / MH_TIMED))
            res["turns"] = turns
            log(f"  {label} ms/substep in turns (device, host to finish): "
                + "; ".join(f"{name} " + ", ".join(
                    f"{d:.4f} / {h:.4f}" for d, h in got_)
                    for name, got_ in turns.items()))
            out[key] = res
            del mw, sw
    finally:
        dist.destroy_process_group()
    log(f"  [20] took {time.perf_counter() - t_phase:.1f} s")
    return out


VIEW_FRAMES = (0.0, 0.004, 0.011, 0.0167, 0.05, 0.02, 10.0, 0.01, 0.0333)
VIEW_SPEED_STEPS = 2            # cmd_speed(+2): speed x4


def accumulator_counts(frame_times, speed: int, phys_step: float,
                       overwork: int) -> list:
    """The substeps of each frame under the reference's accumulator rule
    (main.c:140-163), written out here: bank speed·frame_time (one tick
    for a frame time of 0), cap the bank at overwork·speed ticks, run its
    whole ticks."""
    bank, out = 0.0, []
    for ft in frame_times:
        bank += speed * (phys_step if ft == 0.0 else ft)
        bank = min(bank, speed * phys_step * overwork)
        n = int(bank // phys_step)
        bank -= n * phys_step
        out.append(n)
    return out


def phase_viewer(nt, df, viewer, scene_bench, device) -> dict:
    """[21]: the viewer's ControlState driving a card World."""
    log(f"[21] the viewer's ControlState on a card World, N={BENCH_N}, "
        f"'cuda'; matplotlib imported: {'matplotlib' in sys.modules}, pygame "
        f"imported: {'pygame' in sys.modules} (neither is needed, and the "
        "card machine has neither)")
    if "matplotlib" in sys.modules or "pygame" in sys.modules:
        raise SystemExit("chip_smoke: [21] a GUI library was imported")
    w = nt.create_world(scene_bench, device=device)
    ref = nt.create_world(scene_bench, device=device)
    c = viewer.ControlState(w)
    c.cmd_speed(+VIEW_SPEED_STEPS)
    speed = viewer.SPEEDS[c.speed_idx]
    step = c.phys_step * viewer.STEPS[c.step_idx]
    counts = accumulator_counts(VIEW_FRAMES, speed, c.phys_step,
                                viewer.MAX_OVERWORK)
    df.LAUNCHES = 0
    with no_sync():
        for ft in VIEW_FRAMES:
            c.advance(ft)
    w.block_until_ready()
    launches = df.LAUNCHES
    expect_launches("[21] ControlState.advance", launches, sum(counts))
    for n in counts:
        ref.update(step, n)
    same_bits("[21] ControlState against World.update", w.state, ref.state)
    log(f"  frames {list(VIEW_FRAMES)} at speed x{speed}: substeps {counts}, "
        f"{launches} fused launches, bit-equal to World.update; skipped "
        f"frames {c.skipped_frames}")
    c.cmd_pause()
    df.LAUNCHES = 0
    for ft in VIEW_FRAMES:
        c.advance(ft)
    expect_launches("[21] paused", df.LAUNCHES, 0)
    same_bits("[21] paused", w.state, ref.state)
    c.cmd_pause()
    c.cmd_toggle_backend()  # resets the bank, as a pause does
    n_tab, = accumulator_counts((0.0,), speed, c.phys_step,
                                viewer.MAX_OVERWORK)
    df.LAUNCHES = 0
    with no_sync():
        c.advance(0.0)
    expect_launches("[21] TAB frame on 'torch'", df.LAUNCHES, 0)
    ref.update(step, n_tab, backend="torch")
    same_bits("[21] TAB frame against World.update on 'torch'", w.state,
              ref.state)
    c.cmd_toggle_backend()
    line = c.overlay_text(100.0).splitlines()[0]
    want = f"cuda ({torch.cuda.get_device_name(device)}) simulation"
    if line != want:
        raise SystemExit(f"chip_smoke: [21] overlay {line!r}, expected {want!r}")
    log(f"  paused: 0 launches; TAB frame: {n_tab} substeps on 'torch', 0 "
        f"launches, bit-equal; overlay {line!r}")
    return {"substeps": sum(counts), "launches": launches}


CK_SHARDS = 4
CK_BAD_SHARDS = 8               # a mesh whose padded layout differs
CK_DT = 0.01
CK_SUBSTEPS = 2                 # before the save, and after it on both worlds
CK_LOAD_D2H = 4096              # bytes the load may copy to the host
CK_TURNS = ("dcp", "npz", "npz", "dcp")
KINDS = ("HtoD", "DtoH", "DtoD")
# [22c]: each example's arguments on the card (outputs under build/), the
# cut from its defaults, and the launch counter its path must move
EXAMPLE_RUNS = (
    ("checkpoint_resume", ["2000", "500", "{out}/ck.npz", "{out}/traj.npz"],
     "none (the defaults)", "direct"),
    ("sharded", [], "none (the defaults; one card is a mesh of one shard, "
     "'cuda')", "direct"),
    ("collision", ["{out}/collision.npz", "8000", "30"],
     "30 frames, not 150 (.npz: the card machine has no PIL)", "direct"),
    ("pm_million", ["1048576", "4", "p3m", "{out}/p3m_million.npz"],
     "4 frames, not 60, at N=1048576 on p3m (.npz: no PIL)", "pp"),
    ("accretion", [], "none (the defaults)", "contacts"),
    ("shooting", ["25"], "25 iterations, not 200", "vjp"),
    ("thrust_control", ["25"], "25 iterations, not 150", "vjp"),
    ("multihost_pod", [], "one process, no --distributed (the group path "
     "is [20] and [22b])", "direct"),
)


def copy_bytes(fn, kind: str):
    """fn() in a torch.profiler window: the bytes of the window's CUDA
    memcpys by kind (HtoD, DtoH, DtoD), read from its trace. A window
    with no ``kind`` copy (the profiler has dropped a whole window's device
    events) is run again, up to PROFILE_TRIES windows; then None. Returns
    (bytes by kind or None, fn's result)."""
    from torch.profiler import ProfilerActivity, profile

    trace = ROOT / "build" / "chip_smoke_ckpt" / "window.json"
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        got = dict.fromkeys(KINDS, 0)
        copies = 0
        for e in json.loads(trace.read_text())["traceEvents"]:
            if e.get("cat") != "gpu_memcpy":
                continue
            copies += 1
            for k in KINDS:
                if k in e.get("name", ""):
                    got[k] += int(e.get("args", {}).get("bytes", 0))
        if got[kind] > 0:
            return got, out
        log(f"  profiler window {attempt} of {PROFILE_TRIES}: {copies} "
            f"memcpys, no {kind} bytes")
    return None, out


def shards_equal(label: str, got, want) -> None:
    """Every shard of every field of two sharded worlds bit-equal."""
    for f in FIELDS:
        for k, (a, b) in enumerate(zip(getattr(got, f), getattr(want, f))):
            if not torch.equal(a, b):
                d = (a - b).abs().max()
                raise SystemExit(f"chip_smoke: {label}: {f} of shard {k} not "
                                 f"bit-equal (max |d| {float(d):.3e})")


def timed_s(fn):
    """Host seconds of fn() from a synchronised card to a synchronised
    card, and fn's result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_checkpoint(nt, sh, rf, df, pp, col, multihost, ck, scene_big,
                     smi: str, device) -> dict:
    """[22]: shard-native checkpoints at N=1M D=4 on the card, in one
    process and over an NCCL group of one, then the eight examples."""
    import runpy
    import shutil

    import torch.distributed as dist

    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    mesh = sh.make_mesh(devices=[device] * CK_SHARDS)
    n = scene_big.pos.shape[0]
    hops = CK_SHARDS ** 2 * CK_SUBSTEPS
    log(f"[22a] shard-native checkpoint (torch.distributed.checkpoint): "
        f"N={n}, D={CK_SHARDS} shards on {device}, 'cuda_ring'")
    sw = sh.ShardedWorld(scene_big, mesh, force_backend="cuda_ring")
    rf.LAUNCHES = 0
    sw.update(CK_DT, CK_SUBSTEPS)
    sw.block_until_ready()
    expect_launches("[22a] before the save", rf.LAUNCHES, hops)
    path = str(root / "dcp")
    save_copies, _ = copy_bytes(lambda: ck.save_world_dcp(path, sw,
                                                          step=CK_SUBSTEPS),
                                "DtoH")
    load_copies, (sw2, step) = copy_bytes(
        lambda: ck.load_sharded_world_dcp(path, mesh,
                                          force_backend="cuda_ring"), "HtoD")
    if step != CK_SUBSTEPS or (sw2.n_pad, sw2.mass_len) != (sw.n_pad,
                                                           sw.mass_len):
        raise SystemExit(f"chip_smoke: [22a] restored step {step}, n_pad "
                         f"{sw2.n_pad}, mass_len {sw2.mass_len}")
    for f in FIELDS:
        for k, x in enumerate(getattr(sw2, f)):
            if x.device != mesh[k]:
                raise SystemExit(f"chip_smoke: [22a] {f} of shard {k} on "
                                 f"{x.device}")
    shards_equal("[22a] restored state", sw2, sw)
    state_bytes = sw.n_pad * 32
    gm_bytes = sw.src_len * 4
    if save_copies is None or load_copies is None:
        log(f"  NOT MEASURED: the profiler saw no copy of the state in "
            f"{PROFILE_TRIES} windows (save {save_copies}, load "
            f"{load_copies})")
    else:
        once = {k: "once" if got[kind] == state_bytes else "NOT once"
                for k, got, kind in (("save", save_copies, "DtoH"),
                                     ("load", load_copies, "HtoD"))}
        log(f"  profiler, memcpy bytes: save {save_copies}, load "
            f"{load_copies}; the state is n_pad x 32 = {state_bytes} bytes "
            f"(the save's DtoH: {once['save']}, the load's HtoD: "
            f"{once['load']}), the gm prefix src_len x 4 = {gm_bytes}")
        for label, got in (("save", save_copies), ("load", load_copies)):
            if got["DtoD"] > gm_bytes:
                raise SystemExit(f"chip_smoke: [22a] the {label} copied "
                                 f"{got['DtoD']} bytes device to device, "
                                 f"more than the gm prefix's {gm_bytes}")
        if load_copies["DtoH"] >= CK_LOAD_D2H:
            raise SystemExit(f"chip_smoke: [22a] the load copied "
                             f"{load_copies['DtoH']} bytes to the host")
    rf.LAUNCHES = 0
    sw.update(CK_DT, CK_SUBSTEPS)
    sw2.update(CK_DT, CK_SUBSTEPS)
    sw.block_until_ready()
    sw2.block_until_ready()
    expect_launches("[22a] the two worlds' resumed substeps", rf.LAUNCHES,
                    2 * hops)
    shards_equal("[22a] resumed against the uninterrupted world", sw2, sw)
    log(f"  restored at step {step}, every shard on its device and bit-equal; "
        f"{CK_SUBSTEPS} more substeps on both bit-equal ({2 * hops} hop "
        "launches)")
    del sw2
    try:
        ck.load_sharded_world_dcp(path, [device] * CK_BAD_SHARDS,
                                  force_backend="cuda_ring")
    except ValueError as e:
        if "padded size" not in str(e):
            raise
        log(f"  D={CK_BAD_SHARDS}: ValueError {str(e)[:90]}...")
    else:
        raise SystemExit(f"chip_smoke: [22a] a D={CK_BAD_SHARDS} mesh loaded "
                         f"a D={CK_SHARDS} checkpoint")
    times = {"dcp": [], "npz": []}
    npz = str(root / "ckpt.npz")
    for route in CK_TURNS:
        if route == "dcp":
            save_s, _ = timed_s(lambda: ck.save_world_dcp(path, sw, step=4))
            load_s, _ = timed_s(lambda: ck.load_sharded_world_dcp(
                path, mesh, force_backend="cuda_ring"))
        else:
            save_s, _ = timed_s(lambda: ck.save_world(npz, sw, step=4))
            load_s, _ = timed_s(lambda: ck.load_world(
                npz, sh.ShardedWorld, mesh=mesh, force_backend="cuda_ring"))
        times[route].append((save_s, load_s))
    log(f"  seconds (save, load; in turns {', '.join(CK_TURNS)}; reads warm, "
        f"from the page cache) on {smi}: " + "; ".join(
            f"{route} " + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in got)
            for route, got in times.items()))
    out = {"save_copies": save_copies, "load_copies": load_copies,
           "state_bytes": state_bytes, "gm_bytes": gm_bytes, "times": times,
           "n_pad": sw.n_pad}
    del sw

    log(f"[22b] the same round trip over an NCCL group of one, D={CK_SHARDS} "
        "shards through multihost_world")
    multihost.initialize(f"localhost:{free_port()}", 1, 0,
                         local_device_ids=[device.index or 0])
    try:
        if str(dist.get_backend()) != "nccl":
            raise SystemExit("chip_smoke: [22b] the group is not nccl")
        mw = multihost.multihost_world(scene_big, mesh,
                                       force_backend="cuda_ring")
        if mw.group.pg is None:
            raise SystemExit("chip_smoke: [22b] not a world over the group")
        mw.update(CK_DT, CK_SUBSTEPS)
        gpath = str(root / "dcp_group")
        ck.save_world_dcp(gpath, mw, step=CK_SUBSTEPS)
        mw2, step = ck.load_sharded_world_dcp(gpath, mesh,
                                              force_backend="cuda_ring",
                                              group=dist.group.WORLD)
        if mw2.group.pg is None or step != CK_SUBSTEPS:
            raise SystemExit("chip_smoke: [22b] restored outside the group")
        shards_equal("[22b] restored state", mw2, mw)
        rf.LAUNCHES = 0
        mw.update(CK_DT, CK_SUBSTEPS)
        mw2.update(CK_DT, CK_SUBSTEPS)
        mw.block_until_ready()
        mw2.block_until_ready()
        expect_launches("[22b] resumed substeps", rf.LAUNCHES, 2 * hops)
        shards_equal("[22b] resumed against the uninterrupted world", mw2, mw)
        log(f"  over the group: restored and {CK_SUBSTEPS} more substeps "
            "bit-equal")
        del mw, mw2
    finally:
        dist.destroy_process_group()

    log("[22c] the eight examples on the card (python -m "
        "nbody_tpu_torch.examples.<name>, here through runpy)")
    counters = {"direct": (df, "LAUNCHES"), "pp": (pp, "LAUNCHES"),
                "contacts": (col, "LAUNCHES"), "vjp": (df, "VJP_LAUNCHES")}
    out["examples"] = {}
    argv0 = sys.argv
    for name, args, cut, counter in EXAMPLE_RUNS:
        log(f"  {name}: cut {cut}")
        mod, attr = counters[counter]
        setattr(mod, attr, 0)
        sys.argv = [name] + [a.format(out=root) for a in args]
        t0 = time.perf_counter()
        try:
            runpy.run_module(f"nbody_tpu_torch.examples.{name}",
                             run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        finally:
            sys.argv = argv0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = getattr(mod, attr)
        log(f"  {name}: rc {rc}, {wall:.1f} s wall, {counter} launches "
            f"{launches}")
        if rc != 0 or launches == 0:
            raise SystemExit(f"chip_smoke: [22c] {name} rc {rc}, {launches} "
                             f"{counter} launches")
        out["examples"][name] = {"rc": rc, "s": wall, "launches": launches}
    log(f"  [22] took {time.perf_counter() - t_phase:.1f} s")
    return out


HZ_ROWS = (  # docs/BENCHMARKS.md:290-296, then the two integrators
    (16384, 10000, "cuda", "euler"), (65536, 2000, "cuda", "euler"),
    (65536, 2000, "p3m", "euler"), (65536, 2000, "pm", "euler"),
    (262144, 400, "cuda", "euler"), (65536, 2000, "cuda", "leapfrog"),
    (65536, 2000, "cuda", "yoshida4"))
# the drifts measured on a TPU (docs/BENCHMARKS.md:290-296): physics, not
# speed; logged beside the card's
HZ_TPU = {(16384, "cuda"): (2.4e-5, 1.3e-7), (65536, "cuda"): (1.8e-5, 1.1e-7),
          (65536, "p3m"): (5.0e-4, 3.8e-6), (65536, "pm"): (3.15e-4, 1.2e-4),
          (262144, "cuda"): (2.7e-6, 2.2e-7)}
HZ_DRIFT = {"cuda": 1e-3, "p3m": 5e-3, "pm": 5e-3}
HZ_CLI = ["run", "--n", "6000", "--steps", "10"]


def hz_count(counters: dict, fn):
    """Run ``fn`` with every named counter ((module, attribute)) set to 0;
    (fn's result, {name: launches}) read just after."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def hz_log(label: str, r: dict, launches: dict, wall_s: float) -> None:
    log(f"  {label}: {wall_s:.1f} s wall, {r['device_ms']:.4f} ms/substep "
        f"device, {r['wall_ms']:.4f} ms/substep wall; launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items()))


def phase_physics(nt, df, rf, pp, _build, smi: str, device) -> dict:
    """[23]: physics at horizon on the card, through
    nbody_tpu_torch.scripts."""
    import shutil

    from nbody_tpu_torch import integrators
    from nbody_tpu_torch.scripts import scale_ceiling, validate_physics as vp
    from nbody_tpu_torch.scripts import verify_drive
    from nbody_tpu_torch.utils import cpp_oracle
    from nbody_tpu_torch.utils.compile_cache import (cache_entries,
                                                     enable_compile_cache)

    t_phase = time.perf_counter()
    counters = {"K1": (df, "LAUNCHES"), "K4": (pp, "LAUNCHES"),
                "K3": (rf, "LAUNCHES")}
    out = {}

    def item(label, fn, want: dict):
        """fn() under the counters; each named count must equal its want."""
        t0 = time.perf_counter()
        r, got = hz_count(counters, fn)
        wall = time.perf_counter() - t0
        hz_log(label, r, got, wall)
        for k in counters:
            expect_launches(f"[23] {label}, {k}", got[k], want.get(k, 0))
        return {**r, "launches": got, "s": wall}

    log(f"[23a] the reference binary's 10k-step state: N={vp.REF_N}, "
        f"{vp.REF_STEPS} precise substeps of {vp.REF_DT}, 4x self-noise")
    for backend in ("cuda", "torch"):
        r = item(f"reference binary on {backend}",
                 lambda: vp.reference_binary(backend, device),
                 {"K1": vp.REF_STEPS} if backend == "cuda" else {})
        log(f"    com {r['com']:.3e} (self {r['self_com']:.3e}), momentum "
            f"{r['mom']:.3e} (self {r['self_mom']:.3e}), radial quantiles "
            + ", ".join(f"{a:.3e}" for a in r["rq"]) + " (self " + ", ".join(
                f"{a:.3e}" for a in r["self_rq"]) + ")")
        out[f"ref_{backend}"] = r

    steps = vp.HORIZON_CHUNKS * vp.HORIZON_CHUNK
    log(f"[23b] tests/test_physics_validation.py's single-device cases, "
        f"{steps} substeps of {vp.HORIZON_DT}")
    worlds = {}

    def case(name, backend, want):
        c = vp.HORIZON_CASES[name]

        def go():
            scene, world = vp.horizon_world(name, device, backend)
            worlds[(name, backend)] = world
            r = vp.invariants(world, scene, device)
            vp.check_invariants(f"[23] {name} {backend}", r, c["drift"],
                                c["dp"])
            return r

        r = item(f"{name} {backend or c.get('backend')}", go, want)
        log(f"    worst drift {r['worst_drift']:.3e} (bound {c['drift']:g}), "
            f"|dp|/scale " + ", ".join(f"{x:.2e}" for x in r["dp"])
            + (f" (bound {c['dp']:g})" if c["dp"] else " (not bounded)"))
        return r

    out["torch"] = case("exact", "torch", {})
    out["cuda"] = case("exact", "cuda", {"K1": steps})
    out["pm"] = case("pm", None, {})
    for name in ("leapfrog", "yoshida4"):
        stages = len(integrators.stage_weights(name))
        out[name] = case(name, "cuda", {"K1": stages * steps})
    if not cpp_oracle.available():
        raise SystemExit("chip_smoke: [23] the native oracle cannot be built")
    out["oracle"] = item("oracle N=150 on cuda",
                         lambda: vp.oracle_horizon("cuda", device),
                         {"K1": steps})
    r = out["oracle"]
    log(f"    momentum {r['mom']:.3e} (bound 1e-3), com {r['com']:.3e} "
        f"(bound 1e-2), extent {r['extent']:.3e} (bound 0.2)")
    # the kernels line's row: K1 against its plain version on the "cuda"
    # world's state at the horizon
    world = worlds[("exact", "cuda")]
    st = world.state
    out["k1_err"] = compare_variants(df, f"[23b] N={world.total_len} at the "
                                     "horizon", st.pos, st.vel, st.radius,
                                     world.gm, BOUND_SMALL)
    out["k1_n"], out["k1_s"] = world.total_len, world.mass_len
    worlds.clear()

    c = vp.HORIZON_CASES["ring"]
    log(f"[23c] the ring case: cuda_ring, D={c['shards']} shards on one card, "
        f"N={c['n']}")
    out["ring"] = case("ring", None, {"K3": c["shards"] ** 2 * steps})

    log("[23d] validate_physics at docs/BENCHMARKS.md's rows (TPU values "
        "beside: physics, not speed)")
    out["rows"] = []
    for n, k, backend, integ in HZ_ROWS:
        stages = len(integrators.stage_weights(integ) or (1.0,))
        want = ({"K1": stages * k} if backend == "cuda" else
                {"K1": k, "K4": k} if backend == "p3m" else {})
        r = item(f"N={n} x {k} {backend} {integ}",
                 lambda: vp.main([str(n), str(k), backend, integ]), want)
        bound_ = HZ_DRIFT[backend]
        tpu = HZ_TPU.get((n, backend)) if integ == "euler" else None
        log(f"    worst drift {r['worst_drift']:.3e} (bound {bound_:g}), "
            f"|dp|/scale {r['worst_dp']:.3e}" + (
                f"; on a TPU {tpu[0]:.2e}, {tpu[1]:.2e}" if tpu else ""))
        if not (r["finite"] and r["worst_drift"] < bound_):
            raise SystemExit(f"chip_smoke: [23d] N={n} {backend} {integ}: "
                             f"drift {r['worst_drift']:.3e}")
        out["rows"].append({key: r[key] for key in (
            "n", "steps", "backend", "integrator", "worst_drift", "worst_dp",
            "device_ms", "wall_ms", "launches", "s")})
        del r

    log("[23e] scale_ceiling at its defaults (pm, N=32M, grid 2048)")
    t0 = time.perf_counter()
    r, got = hz_count(counters, lambda: scale_ceiling.main([]))
    r["s"] = time.perf_counter() - t0
    log(f"  scene {r['scene_s']:.4f} s, world {r['world_s']:.4f} s, "
        f"{r['ms']:.4f} ms/substep device, peak {r['peak_gib']:.4f} of "
        f"{r['total_gib']:.4f} GiB; {r['s']:.1f} s wall; launches {got} "
        f"[{smi}]")
    out["scale"] = {k: r[k] for k in ("n", "grid", "scene_s", "world_s", "ms",
                                      "peak_gib", "total_gib", "s",
                                      "updates_per_s")}
    del r

    log("[23f] verify_drive")
    frame = ROOT / "build" / "chip_smoke_verify" / "frame.ppm"
    t0 = time.perf_counter()
    r, got = hz_count(counters, lambda: verify_drive.main(
        ["--out", str(frame)]))
    log(f"  {time.perf_counter() - t0:.1f} s wall, lit {r['lit']}, mix "
        f"{r['mix']} {r['mix_err']:.2e}, launches {got}")
    if r["mix"] != ("torch", "cuda") or got["K1"] < r["steps"]:
        raise SystemExit(f"chip_smoke: [23f] mix {r['mix']}, K1 {got['K1']}")
    out["verify"] = {"s": time.perf_counter() - t0, "launches": got["K1"]}
    del r

    log("[23g] the compile cache")
    cache = ROOT / "build" / "chip_smoke_cache"
    shutil.rmtree(cache, ignore_errors=True)
    try:
        enable_compile_cache(str(cache))
        t0 = time.perf_counter()
        path, cold = _build.build_all(["direct_forces"])["direct_forces"]
        cold_wall = time.perf_counter() - t0
        if path.parent != cache or not cold > 0:
            raise SystemExit(f"chip_smoke: [23g] built {path} in {cold} s")
        t0 = time.perf_counter()
        again = _build.build_all(["direct_forces"])["direct_forces"][1]
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        import ctypes

        ctypes.CDLL(str(path))
        dlopen_s = time.perf_counter() - t0
    finally:
        _build.set_build_dir(None)
    files = {f.name: (f.stat().st_mtime_ns, f.stat().st_size)
             for f in cache.iterdir()}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "nbody_tpu_torch",
                           "--compile-cache", str(cache), *HZ_CLI], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    tail = " | ".join(proc.stderr.strip().splitlines()[-2:])
    log(f"  $ python -m nbody_tpu_torch --compile-cache {cache} "
        f"{' '.join(HZ_CLI)}: rc {proc.returncode}, {cli_s:.1f} s wall; {tail}")
    after = {f.name: (f.stat().st_mtime_ns, f.stat().st_size)
             for f in cache.iterdir()}
    entries = cache_entries(str(cache))
    if (proc.returncode != 0 or after != files or entries != 1
            or "built in this process: none" not in proc.stderr):
        raise SystemExit(f"chip_smoke: [23g] rc {proc.returncode}, cache "
                         f"{files} -> {after}, {entries} entries: "
                         f"{proc.stderr[-2000:]}")
    log(f"  cold: nvcc {cold:.2f} s ({cold_wall:.2f} s wall); warm: "
        f"build_all {warm_s:.4f} s (reported build {again} s: nvcc "
        f"--version and the file), dlopen {dlopen_s:.4f} s; the CLI "
        f"subprocess built nothing, the directory unchanged, "
        f"cache_entries {entries} [{smi}]")
    out["cache"] = {"cold_s": cold, "warm_s": warm_s, "dlopen_s": dlopen_s,
                    "cli_s": cli_s, "entries": entries}
    out["s"] = time.perf_counter() - t_phase
    log(f"  [23] took {out['s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nbody_tpu_torch as nt
    from nbody_tpu_torch import diagnostics, forces
    from nbody_tpu_torch import world as world_mod
    from nbody_tpu_torch.models import galaxy_ref
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import collisions
    from nbody_tpu_torch.ops import direct_forces as df
    from nbody_tpu_torch.ops import p3m_forces
    from nbody_tpu_torch.ops import p3m_pp as pp
    from nbody_tpu_torch.ops import pm_forces
    from nbody_tpu_torch.ops import ring_forces as rf
    from nbody_tpu_torch.ops import sass
    from nbody_tpu_torch import viewer
    from nbody_tpu_torch.parallel import multihost
    from nbody_tpu_torch.parallel import sharding as sh
    from nbody_tpu_torch.utils import checkpoint as ck
    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    log("[0] environment")
    smi = phase_env()
    device = torch.device(DEVICE)
    phase_build(_build)
    pair_loops(_build, sass)

    log("[2] kernel against its plain version on the card")
    pos, vel, radius, gm = random_state(1000, 333, device)
    df.PLANS.clear()
    compare_variants(df, "N=1000 S=333", pos, vel, radius, gm, BOUND_SMALL)
    compare_variants(df, "N=1000 S=0", pos, vel, radius, gm[:0], BOUND_SMALL)
    log_plans("N=1000", df.PLANS)
    forced_clusters(df, device)

    scene_bench = nt.make_galaxies(BENCH_N, 2, seed=SEED)
    t0 = time.perf_counter()
    scene_big = nt.make_galaxies(BIG_N, 2, seed=SEED)
    host_gen_s = time.perf_counter() - t0
    bench = nt.create_world(scene_bench, device=device)
    st = bench.state
    err_bench = compare_variants(df, f"N={BENCH_N} S={bench.mass_len}", st.pos,
                                 st.vel, st.radius, bench.gm, BOUND_SMALL)
    log_plans(f"N={BENCH_N}", df.PLANS)
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
    log_plans(f"N={BIG_N} ({SUBSET} targets for force_acc)", df.PLANS)

    phase_golden(nt, galaxy_ref, load_hex_dump, device)

    log(f"[4] main path: N={BENCH_N}, 2 galaxies, seed {SEED}, default config")
    world = nt.create_world(scene_bench, device=device)
    df.LAUNCHES = 0
    df.PLANS.clear()
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
    log_plans("main path", df.PLANS)
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
    df.PLANS.clear()
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
    log_plans("update_gpu", df.PLANS)
    big_plain_ms = cuda_ms(lambda: big.update(1.0, 1, backend="torch"))
    log(f"  plain: {big_plain_ms:.1f} ms/substep")

    slice_w = nt.create_world(scene_big, config=nt.SimConfig(**P3M_SIZED),
                              device=device)
    default_w = nt.create_world(scene_bench, config=nt.SimConfig(**P3M_DEFAULT),
                                device=device)
    k4 = phase_pp(pp, p3m_forces, slice_w, default_w, device)
    del default_w
    split = phase_split(df, p3m_forces, slice_w, device)
    p3m = phase_p3m(nt, df, pp, p3m_forces, scene_big, scene_bench, device,
                    big_ms)
    mesh_repeat(nt, pm_forces, scene_big, device)
    phase_accuracy(nt, df, slice_w, device)
    sizing_table(nt, p3m_forces, device)

    phase_ring_hop(rf, df, device)
    phase_race(nt, sh, rf, df, galaxy_ref, load_hex_dump, scene_bench, device)
    shard = phase_sharded(sh, rf, df, scene_bench, scene_big, device)
    ablation = phase_ablations(nt, df, device)
    ablation.update(phase_probes(device, _build, sass))
    idle = [key for key in ABLATION_KERNELS if not ablation[key]["launches"]]
    if idle:
        raise SystemExit(f"chip_smoke: a kernel of the ablation path was not "
                         f"launched: {idle}")
    hooks = phase_hooks(nt, sh, df, rf, pp, world_mod, diagnostics,
                        scene_bench, scene_big, device)
    merge = phase_merge(nt, sh, df, rf, pp, world_mod, diagnostics,
                        scene_bench, scene_big, device)
    rollouts = phase_autodiff(nt, df, pp, p3m_forces, _build, sass,
                              scene_bench, scene_big, slice_w, device)
    del slice_w
    mesh = phase_mesh(nt, sh, df, pp, p3m_forces, world_mod, scene_bench,
                      scene_big, device)
    log("[19] the device-side scenes, K1 with every row a source, the AVX "
        "oracle")
    scn = phase_scenes(nt, df, pp, p3m_forces, scene_bench, host_gen_s, smi,
                       device)
    mh = phase_multihost(nt, sh, df, rf, pp, p3m_forces, multihost,
                         scene_bench, scene_big, device)
    view = phase_viewer(nt, df, viewer, scene_bench, device)
    ckpt = phase_checkpoint(nt, sh, rf, df, pp, collisions, multihost, ck,
                            scene_big, smi, device)
    del scene_big
    log("[23] physics at horizon on the card (nbody_tpu_torch.scripts)")
    phys = phase_physics(nt, df, rf, pp, _build, smi, device)

    mk = merge["kernel"]
    log(f"card: {smi}")
    log(f"rsqrt path vs fp64 at N={BENCH_N}: max|d|/max|a| {acc64['rsqrt'][0]:.3e}, "
        f"precise {acc64['precise'][0]:.3e}")
    log(f"p3m ms/substep: N={BIG_N} slice config {p3m['ms']:.4f} (direct "
        f"{big_ms:.4f}); N={BENCH_N} default config {p3m['bench']['ms']:.4f} "
        f"(direct {kernel_ms:.4f})")
    log("sharded cuda_ring ms/substep on one card: " + ", ".join(
        f"N={n} D={d} {shard[(n, d)]['cuda_ring']['ms']:.4f}" for n, d in SHARDED)
        + f" (World 'cuda': N={BENCH_N} {kernel_ms:.4f}, N={BIG_N} {big_ms:.4f})")
    # the shards' launches overlap, so their summed durations overstate the
    # card's time; the kernels line takes the union of their intervals
    log("ring_hop_kernel device ms/substep (profiler; the union of its "
        "launches' intervals, their sum in brackets): " + ", ".join(
            f"N={n} D={d} {shard[(n, d)]['profile']['kernel_busy_ms']:.4f} "
            f"({shard[(n, d)]['profile']['kernel_sum_ms']:.4f})"
            for n, d in SHARDED if d > 1))

    t_d, t_p, ad = hooks["times_direct"], hooks["times_p3m"], hooks["adaptive"]
    log(f"hooks ms/substep on the card, device: N={BENCH_N} 'cuda' unhooked "
        f"{t_d['unhooked'][0]:.4f}, hooked {t_d['hooked'][0]:.4f}; N={BIG_N} "
        f"p3m slice unhooked {t_p['unhooked'][0]:.4f}, hooked "
        f"{t_p['hooked'][0]:.4f}")
    log(f"adaptive ms/substep on the card, device: N={BENCH_N} 'cuda' "
        f"{ad['times']['ms']:.4f} over {ad['times']['k']} substeps (fixed dt "
        f"{ad['times']['fixed_ms']:.4f}); N={BIG_N} p3m slice "
        f"{hooks['p3m_adaptive']['ms']:.4f} over {hooks['p3m_adaptive']['k']}")
    log(f"merging ms/substep on the card, device: N={BENCH_N} 'cuda' "
        f"{merge['world']['times']['merging'][0]:.4f} (unmerged "
        f"{merge['world']['times']['unmerged'][0]:.4f}); contact kernel "
        f"{mk['ms']:.4f} (plain {mk['plain_ms']:.4f}, bound "
        f"{mk['bound_ms']:.6f}), N={BIG_N} {mk['big']['ms']:.4f} (bound "
        f"{mk['big']['bound_ms']:.6f}, {mk['big']['candidates']} candidate "
        f"pairs); p3m slice "
        f"merging {merge['p3m']['ms']:.4f}; CLI run/render/resume/gif "
        + ", ".join(f"{x:.1f}" for x in merge["cli"]) + " s")
    ad_c, ad_p = rollouts["cuda"], rollouts["p3m"]
    vjp1, vjp4 = rollouts["k1"], rollouts["k4"]
    log(f"rollouts ms/step on the card, device: N={BENCH_N} 'cuda' precise "
        f"forward {ad_c['fwd_ms']:.4f}, forward and backward "
        f"{ad_c['both_ms']:.4f} (peak {ad_c['peak_mib']:.1f} MiB); N={BIG_N} "
        f"'p3m' slice forward {ad_p['fwd_ms']:.4f}, forward and backward "
        f"{ad_p['both_ms']:.4f} (peak {ad_p['peak_mib']:.1f} MiB); K1 VJP "
        f"{vjp1['ms']:.4f} (precise; bound {vjp1['bound_ms']:.4f}), K4 VJP "
        f"N={BIG_N} {vjp4['big_ms']:.4f} (bound {vjp4['big_bound_ms']:.4f}, "
        f"scratch {vjp4['big']['scratch_mib']:.1f} MiB), N={BENCH_N} "
        f"{vjp4['ms']:.4f} (bound {vjp4['bound_ms']:.4f}, scratch "
        f"{vjp4['scratch_mib']:.1f} MiB)")
    tn = {name: float(np.mean([d for d, _ in got]))
          for name, got in mesh["turns"].items()}
    log(f"sharded mesh ms/substep on one card, D={MESH_SHARDS}, device: N="
        f"{BIG_N} slice p3m {mesh['slice']['ms']:.4f} (host to enqueue "
        f"{mesh['slice']['enqueue_ms']:.4f}), pm {mesh['pm']['ms']:.4f}; in "
        f"turns p3m {tn['sharded p3m']:.4f}, pm {tn['sharded pm']:.4f}, World "
        f"p3m {tn['World p3m']:.4f}; N={BENCH_N} default p3m "
        f"{mesh['default']['ms']:.4f}; rollout_sharded p3m N={BENCH_N} "
        f"{mesh['rollout_ms']:.4f} ms/step with its backward")
    sk, so, sp = scn["k1"], scn["oracle"], scn["p3m"]
    log(f"device scenes on the card: " + ", ".join(
        f"{name} {r['device_ms']:.4f} ms device, {r['wall_us'] / 1e3:.4f} ms "
        f"wall" for name, r in scn["scenes"].items())
        + f" (host numpy galaxies at N={BIG_N}: {host_gen_s * 1e3:.1f} ms); "
        f"K1 on the Plummer scene S = N = {sk['n']}: {sk['ms']:.4f} ms/substep,"
        f" {sk['n'] * sk['s'] / (sk['ms'] * 1e-3):.4e} pairs/s, "
        f"{sk['bound_ms'] / sk['ms']:.1%} of its bound; the AVX oracle "
        f"against the card at N={BENCH_N}: acc {so['acc']:.3e}, vel "
        f"{so['vel']:.3e}, pos {so['pos']:.3e}; device galaxies p3m "
        f"{sp['ms']:.4f} ms/substep")
    mt = {key: {name: float(np.mean([d for d, _ in got]))
                for name, got in r["turns"].items()}
          for key, r in mh.items()}
    log(f"multi-process on the card (NCCL group of 1, D={MH_SHARDS} on one "
        f"card), device ms/substep, multihost_world / single-process: "
        f"N={BENCH_N} cuda_ring {mt['ring']['multihost']:.4f} / "
        f"{mt['ring']['single']:.4f}; N={BIG_N} p3m slice "
        f"{mt['p3m']['multihost']:.4f} / {mt['p3m']['single']:.4f}; "
        f"viewer: {view['substeps']} substeps through ControlState")
    ct = {route: [np.mean([x[i] for x in got]) for i in (0, 1)]
          for route, got in ckpt["times"].items()}
    log(f"checkpoints at N={BIG_N} D={CK_SHARDS} on one card, seconds save / "
        f"load (mean of 2 in turns): torch.distributed.checkpoint "
        f"{ct['dcp'][0]:.4f} / {ct['dcp'][1]:.4f}, npz {ct['npz'][0]:.4f} / "
        f"{ct['npz'][1]:.4f}; memcpy bytes save {ckpt['save_copies']}, load "
        f"{ckpt['load_copies']} (n_pad x 32 = {ckpt['state_bytes']}); "
        "examples " + ", ".join(f"{k} {v['s']:.1f} s" for k, v in
                                ckpt["examples"].items()))
    log(f"physics at horizon on the card, device ms/substep: reference "
        f"binary 10k cuda {phys['ref_cuda']['device_ms']:.4f}, torch "
        f"{phys['ref_torch']['device_ms']:.4f}; N=1024 cuda "
        f"{phys['cuda']['device_ms']:.4f}, torch "
        f"{phys['torch']['device_ms']:.4f}, pm {phys['pm']['device_ms']:.4f}, "
        f"leapfrog {phys['leapfrog']['device_ms']:.4f}, yoshida4 "
        f"{phys['yoshida4']['device_ms']:.4f}, ring D=8 "
        f"{phys['ring']['device_ms']:.4f}; rows " + ", ".join(
            f"{r['n']}x{r['steps']} {r['backend']} {r['integrator']} drift "
            f"{r['worst_drift']:.3e} {r['device_ms']:.4f}"
            for r in phys["rows"]) + f"; scale ceiling N="
        f"{phys['scale']['n']} world {phys['scale']['world_s']:.4f} s, "
        f"{phys['scale']['ms']:.4f} ms/substep, peak "
        f"{phys['scale']['peak_gib']:.4f} GiB; cache cold "
        f"{phys['cache']['cold_s']:.2f} s, warm "
        f"{phys['cache']['warm_s']:.4f} s; [23] {phys['s']:.1f} s")
    log("ablation path, best ms of each sweep: " + ", ".join(
        f"{key} {ablation[key]['best']['ms']:.4f} ({ablation[key]['best']['name']})"
        for key in ABLATION_KERNELS) + f" (K1 force_acc {ablation['k1_ms']:.4f})")

    def fused_row(n, s, replaces, launches, err, ms, plain):
        b_ms, b_by = bound(FLOPS_DIRECT * n * s, 44 * n + 4 * s,
                           MUFU_DIRECT * n * s)
        return {"name": f"direct_forces fused substep, N={n} S={s}",
                "route": "cuda", "source": KERNEL_SRC, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}

    def pp_row(key, cfg, launches):
        r = k4[key]
        return {"name": f"p3m_pp pair correction, cells route, gc="
                        f"{cfg['pm_grid'] // 4} cap={cfg['p3m_cell_capacity']}, "
                        f"N={r['n']}",
                "route": "cuda", "source": PP_SRC,
                "replaces": "nbody_tpu/ops/p3m_pallas.py:38",
                "launches": launches, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    def ring_row(n, d):
        r = shard[(n, d)]
        b_ms, b_by = bound(FLOPS_DIRECT * n * r["mass_len"],
                           48 * r["n_pad"] + 4 * r["mass_len"],
                           MUFU_DIRECT * n * r["mass_len"])
        return {"name": f"ring_forces hop, sharded substep N={n} D={d} "
                        f"S={r['mass_len']}, D shards on one card",
                "route": "cuda", "source": RING_SRC,
                "replaces": "nbody_tpu/ops/ring_forces.py:58",
                "launches": r["cuda_ring"]["launches"],
                "max_abs_err": r["max_abs_err"],
                "ms": r["profile"]["kernel_busy_ms"],
                "plain_ms": r["torch"]["ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    def ablation_row(key):
        r = ablation[key]
        best = r["best"]
        source, replaces = ABLATION_KERNELS[key]
        return {"name": r.get("label") or f"{key} {best['name']}, N={BENCH_N} "
                                          f"(best of the module's sweep)",
                "route": "cuda", "source": source, "replaces": replaces,
                "launches": r["launches"], "max_abs_err": best["max_abs_err"],
                "ms": best["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    def hooked_row(r, label, source, replaces):
        return {"name": f"{label}, N={r['n']} S={r['s']}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    def shard_pp_row(key, cfg):
        r = mesh[key]
        k4 = r["k4"]
        return {"name": f"p3m_pp pair correction on shard {k4['shard']} of "
                        f"D={MESH_SHARDS} on one card, cells route with the "
                        f"global-rank cut, gc={cfg['pm_grid'] // 4} "
                        f"cap={cfg['p3m_cell_capacity']}, N="
                        f"{BIG_N if key == 'slice' else BENCH_N}",
                "route": "cuda", "source": PP_SRC,
                "replaces": "nbody_tpu/ops/p3m_pallas.py:38",
                "launches": r["launches"]["pp"],
                "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
                "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
                "bound_by": k4["bound_by"], "library_ms": None}

    def mh_ring_row():
        r = mh["ring"]
        b_ms, b_by = bound(FLOPS_DIRECT * r["n"] * r["mass_len"],
                           48 * r["n_pad"] + 4 * r["mass_len"],
                           MUFU_DIRECT * r["n"] * r["mass_len"])
        return {"name": f"ring_forces hop through multihost_world, NCCL group "
                        f"of 1, N={r['n']} D={MH_SHARDS} S={r['mass_len']} on "
                        f"one card, sources all-gathered",
                "route": "cuda", "source": RING_SRC,
                "replaces": "nbody_tpu/ops/ring_forces.py:58",
                "launches": r["launches"]["K3"],
                "max_abs_err": r["max_abs_err"],
                "ms": r["k3_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}

    def mh_pp_row():
        r = mh["p3m"]
        k4 = r["k4"]
        return {"name": f"p3m_pp pair correction through multihost_world, "
                        f"NCCL group of 1, shard {k4['shard']} of "
                        f"D={MH_SHARDS} on one card, gc="
                        f"{P3M_SIZED['pm_grid'] // 4} "
                        f"cap={P3M_SIZED['p3m_cell_capacity']}, N={r['n']}",
                "route": "cuda", "source": PP_SRC,
                "replaces": "nbody_tpu/ops/p3m_pallas.py:38",
                "launches": r["launches"]["K4"],
                "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
                "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
                "bound_by": k4["bound_by"], "library_ms": None}

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
        ring_row(BENCH_N, 4),
        ring_row(BIG_N, 4),
        *(ablation_row(key) for key in ABLATION_KERNELS),
        hooked_row(hooks["force_acc"], "direct_forces force_acc, hooked World "
                   "substep", KERNEL_SRC, "nbody_tpu/ops/pallas_forces.py:220"),
        hooked_row(hooks["sharded"]["cuda_ring"], "ring_forces hop without "
                   "epilogue, hooked sharded substep D=4 on one card, one "
                   "pass of the ring", RING_SRC,
                   "nbody_tpu/ops/ring_forces.py:58"),
        {"name": f"merge_contacts contact search on a cell grid, merging "
                 f"World N={BENCH_N} after {MERGE_SUBSTEPS} substeps, "
                 f"M={mk['m']}, {mk['candidates']} candidate pairs",
         "route": "cuda", "source": MERGE_SRC,
         "replaces": "nbody_tpu/ops/collisions.py:75",
         "launches": merge["world"]["launches"], "max_abs_err": 0.0,
         "ms": mk["ms"], "plain_ms": mk["plain_ms"], "bound_ms": mk["bound_ms"],
         "bound_by": mk["bound_by"], "library_ms": None},
        {"name": f"direct_vjp force_acc VJP (one pass over the pairs), "
                 f"'cuda' rollout N={vjp1['n']} S={vjp1['s']} precise",
         "route": "cuda", "source": VJP_SRC,
         "replaces": "nbody_tpu/ops/pallas_forces.py:577",
         "launches": ad_c["launches"], "max_abs_err": vjp1["max_abs_err"],
         "ms": vjp1["ms"], "plain_ms": vjp1["plain_ms"],
         "bound_ms": vjp1["bound_ms"], "bound_by": vjp1["bound_by"],
         "library_ms": None},
        {"name": f"p3m_pp_vjp pair-correction VJP (one pass over the pairs), "
                 f"'p3m' rollout N={BENCH_N} grid {P3M_DEFAULT['pm_grid']} "
                 f"cap={P3M_DEFAULT['p3m_cell_capacity']}",
         "route": "cuda", "source": PP_VJP_SRC,
         "replaces": "nbody_tpu/ops/p3m_pallas.py:197",
         "launches": rollouts["p3m_default"]["launches"]["K4 VJP"],
         "max_abs_err": vjp4["max_abs_err"], "ms": vjp4["ms"],
         "plain_ms": vjp4["plain_ms"], "bound_ms": vjp4["bound_ms"],
         "bound_by": vjp4["bound_by"], "library_ms": None},
        shard_pp_row("slice", P3M_SIZED),
        shard_pp_row("default", P3M_DEFAULT),
        {"name": f"K1, all-massive Plummer scene, S = N = {sk['n']} "
                 f"(fused substep)",
         "route": "cuda", "source": KERNEL_SRC,
         "replaces": "nbody_tpu/ops/pallas_forces.py:220",
         "launches": sk["launches"], "max_abs_err": sk["max_abs_err"],
         "ms": sk["ms"], "plain_ms": sk["plain_ms"],
         "bound_ms": sk["bound_ms"], "bound_by": sk["bound_by"],
         "library_ms": None},
        mh_ring_row(),
        mh_pp_row(),
        {**fused_row(phys["k1_n"], phys["k1_s"],
                     "nbody_tpu/ops/pallas_forces.py:220",
                     phys["cuda"]["launches"]["K1"], phys["k1_err"],
                     phys["cuda"]["device_ms"], phys["torch"]["device_ms"]),
         "name": f"direct_forces fused substep over 10,000 substeps, "
                 f"tests/test_physics_validation.py's one-galaxy scene "
                 f"N={phys['k1_n']} S={phys['k1_s']}"},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
