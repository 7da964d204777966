"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor nbody_tpu, so it runs on a machine that has only
PyTorch; there, run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerance: max|Δ|/max|ref| < 1e-5 on forces. Kernel and plain version run
the same fp32 formula; they differ in the order of the S-term sums, in FMA
contraction, and (rsqrt path) in the hardware rsqrt's last bits. The fused
epilogue is held to 1e-6 against the plain update applied to the kernel's
own force: there the only difference is FMA contraction, ~1 ulp. (Holding
the new positions to the plain positions directly would scale the force
error by dt² max|a| / max|x|, which a zero-radius tracer makes large.)
"""

import numpy as np
import pytest
import torch
from torch_helpers import cuda, random_arrays, rel_err  # noqa: F401 (fixture)

import nbody_tpu_torch as nt
from nbody_tpu_torch.ops import bcast_probe as bp
from nbody_tpu_torch.ops import collisions as col
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import flavor_forces as ff
from nbody_tpu_torch.ops import op_probe as op
from nbody_tpu_torch.ops import newton_forces as nwf
from nbody_tpu_torch.ops import ptile_forces as ptf
from nbody_tpu_torch.ops import resident_forces as rsf
from nbody_tpu_torch.ops import stationary_forces as stf
from nbody_tpu_torch.ops import p3m_forces, p3m_pp
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh

pytestmark = pytest.mark.cuda

TOL = 1e-5
EPILOGUE_TOL = 1e-6


def _inputs(device, n, n_src, seed=0, zero_radius_tracers=True):
    pos, vel, mass, radius = random_arrays(n, seed=seed)
    if zero_radius_tracers:
        radius = np.where(mass == 0, 0.0, radius).astype(np.float32)
    gm = (10.0 * np.maximum(mass[:n_src], 1.0)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (pos, vel, radius, gm)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("n,n_src", [(1000, 333), (1000, 0), (257, 1), (300, 300),
                                     (4096, 3000)])
def test_force_acc_matches_plain(cuda, precise, n, n_src):
    pos, _, radius, gm = _inputs(cuda, n, n_src)
    got = df.force_acc(pos, radius, pos[:n_src], gm, precise=precise)
    want = df.force_acc_plain(pos, radius, pos[:n_src], gm, precise=precise)
    torch.cuda.synchronize()
    if n_src == 0:
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("pos_dt", [1.0, 0.5])
def test_fused_substep_matches_plain(cuda, precise, pos_dt):
    pos, vel, radius, gm = _inputs(cuda, 1000, 333)
    npos, nvel, acc = df.fused_substep(0.01, pos, vel, radius, gm,
                                       precise=precise, pos_dt=pos_dt)
    _, _, acc_w = df.fused_substep_plain(0.01, pos, vel, radius, gm,
                                         precise=precise, pos_dt=pos_dt)
    assert rel_err(acc.cpu(), acc_w.cpu()) < TOL
    nvel_w = vel + 0.01 * acc
    npos_w = pos + df._pos_dt_times_dt(pos_dt, 0.01) * nvel
    assert rel_err(nvel.cpu(), nvel_w.cpu()) < EPILOGUE_TOL
    assert rel_err(npos.cpu(), npos_w.cpu()) < EPILOGUE_TOL
    # inputs untouched (Jacobi: the kernel writes fresh buffers)
    assert npos.data_ptr() != pos.data_ptr() and nvel.data_ptr() != vel.data_ptr()


def test_streamed_source_count_matches_plain(cuda):
    """More sources than the TPU kernel kept resident (131072): the same
    kernel, a longer tile loop. The plain version runs on 512 targets."""
    n_src = 140_000
    pos, _, radius, gm = _inputs(cuda, n_src, n_src, seed=3)
    got = df.force_acc(pos[:512].contiguous(), radius[:512].contiguous(),
                       pos, gm)
    want = df.force_acc_plain(pos[:512], radius[:512], pos, gm)
    assert rel_err(got.cpu(), want.cpu()) < 1e-4


@pytest.mark.parametrize("precise", [True, False])
def test_zero_radius_tracer_on_zero_gm_source_is_zero(cuda, precise):
    pos = torch.zeros((2, 2), device=cuda)
    radius = torch.zeros(2, device=cuda)
    acc = df.force_acc(pos, radius, pos, torch.zeros(2, device=cuda), precise=precise)
    assert torch.equal(acc.cpu(), torch.zeros((2, 2)))


def test_non_contiguous_cuda_input_raises(cuda):
    """A CUDA tensor launches the kernel or raises: no plain fallback."""
    pos, vel, radius, gm = _inputs(cuda, 64, 10)
    with pytest.raises(ValueError):
        df.fused_substep(0.01, pos, vel.t().contiguous().t(), radius, gm)


@pytest.mark.parametrize("integrator,per_substep", [("euler", 1), ("leapfrog", 1),
                                                    ("yoshida4", 3)])
def test_world_cuda_matches_torch_backend(cuda, integrator, per_substep):
    p = nt.make_galaxies(2000, 2, seed=11037)
    cfg = nt.SimConfig(integrator=integrator)
    w_k = nt.create_world(p, config=cfg, device=cuda)
    w_p = nt.create_world(p, config=cfg, device=cuda)
    assert w_k.default_backend == "cuda"
    df.LAUNCHES = 0
    w_k.update(0.01, 5)
    assert df.LAUNCHES == 5 * per_substep
    w_p.update(0.01, 5, backend="torch")
    assert df.LAUNCHES == 5 * per_substep
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w_k.particles, name), getattr(w_p.particles, name)
        assert rel_err(got, want) < TOL, name


# --- the source-split force_acc ---

@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("t,n_src", [(64, 140_000), (1000, 333)])
def test_force_acc_source_split_matches_plain(cuda, precise, t, n_src):
    """Few targets: the launch splits the source sum (cluster_plan's
    n_split > 1: a scratch reduce of ~260 ranges at S = 140000, a cluster
    of 2 at S = 333)."""
    assert df.cluster_plan(t, n_src, df.device_sms(cuda)).n_split > 1
    pos, _, radius, gm = _inputs(cuda, max(t, n_src), n_src, seed=5)
    tp, tr = pos[:t].contiguous(), radius[:t].contiguous()
    before = df.LAUNCHES
    got = df.force_acc(tp, tr, pos[:n_src], gm, precise=precise)
    assert df.LAUNCHES == before + 1
    want = df.force_acc_plain(tp, tr, pos[:n_src], gm, precise=precise)
    assert rel_err(got.cpu(), want.cpu()) < (1e-4 if n_src > 100_000 else TOL)
    # the split sums in a fixed order: the same bits on every run
    again = df.force_acc(tp, tr, pos[:n_src], gm, precise=precise)
    assert torch.equal(got, again)


# --- the plans of the main-path pair loop (csrc/direct_tiles.cuh) ---

# (p, n_split): each P unsplit and with a cluster split; a cluster of 8
# over 12 runs (S = 3000); one over 2 runs (S = 333), 6 ranges empty.
PLANS = [(1, 1), (2, 1), (1, 2), (2, 3), (1, 5), (2, 8)]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("n,n_src", [(1000, 333), (4096, 3000)])
@pytest.mark.parametrize("precise", [True, False])
def test_fused_substep_plans_match_plain(cuda, precise, n, n_src, plan):
    """Every P, with and without a cluster, against the plain version; two
    runs bit-equal."""
    pos, vel, radius, gm = _inputs(cuda, n, n_src, seed=7)
    before = df.LAUNCHES
    runs = [df.fused_substep(0.01, pos, vel, radius, gm, precise=precise,
                             plan=plan) for _ in range(2)]
    assert df.LAUNCHES == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    npos, nvel, acc = runs[0]
    want = df.force_acc_plain(pos, radius, pos[:n_src], gm, precise=precise)
    assert rel_err(acc.cpu(), want.cpu()) < TOL
    assert rel_err(nvel.cpu(), (vel + 0.01 * acc).cpu()) < EPILOGUE_TOL
    assert rel_err(npos.cpu(), (pos + 0.01 * nvel).cpu()) < EPILOGUE_TOL


@pytest.mark.parametrize("plan", PLANS + [(1, 12), (2, 12)])
@pytest.mark.parametrize("precise", [True, False])
def test_force_acc_plans_match_plain(cuda, precise, plan):
    """force_acc with each plan, more than 8 ranges through the scratch;
    two runs bit-equal."""
    pos, _, radius, gm = _inputs(cuda, 4096, 3000, seed=8)
    got, again = (df.force_acc(pos, radius, pos[:3000], gm, precise=precise,
                               plan=plan) for _ in range(2))
    assert torch.equal(got, again)
    want = df.force_acc_plain(pos, radius, pos[:3000], gm, precise=precise)
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("precise", [True, False])
def test_ring_hop_plans_match_plain(cuda, precise, last, plan):
    """The hop kernel with each plan against its plain version; two runs
    bit-equal."""
    pos, vel, radius, gm = _inputs(cuda, 4096, 3000, seed=9)
    valid = (torch.arange(4096, device=cuda) < 4000).float()
    run0 = df.force_acc_plain(pos, radius, pos[:50], gm[:50])
    kw = dict(vel=vel, valid=valid, dt=0.01) if last else {}
    outs = []
    for _ in range(2):
        run = run0.clone()
        got = rf.ring_hop(pos, radius, pos, gm, run, accumulate=True,
                          precise=precise, plan=plan, **kw)
        outs.append(got[2] if last else run)
    assert torch.equal(outs[0], outs[1])
    run = run0.clone()
    want = rf.ring_hop_plain(pos, radius, pos, gm, run, accumulate=True,
                             precise=precise, **kw)
    want = want[2] if last else run
    assert rel_err(outs[0].cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("precise", [True, False])
def test_unsplit_plans_are_bit_equal(cuda, precise):
    """At n_split = 1 each target sums its runs in source order whatever
    P: the same bits."""
    pos, vel, radius, gm = _inputs(cuda, 4096, 3000, seed=10)
    ref = df.fused_substep(0.01, pos, vel, radius, gm, precise=precise,
                           plan=(1, 1))
    got = df.fused_substep(0.01, pos, vel, radius, gm, precise=precise,
                           plan=(2, 1))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,n_src", [(4096, 3000), (20_000, 9000)])
@pytest.mark.parametrize("precise", [True, False])
def test_ring_hop_d1_is_bit_equal_to_fused_substep(cuda, precise, n, n_src):
    """One shard's only hop (accumulate off, the epilogue, every row valid)
    plans as World does and gives fused_substep's bits."""
    pos, vel, radius, gm = _inputs(cuda, n, n_src, seed=11)
    want = df.fused_substep(0.01, pos, vel, radius, gm, precise=precise)
    got = rf.ring_hop(pos, radius, pos, gm, torch.empty_like(pos),
                      accumulate=False, precise=precise, vel=vel,
                      valid=torch.ones(n, device=cuda), dt=0.01)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_refused_cluster_launch_raises(cuda):
    """A cluster of 16 blocks is past the portable size the kernels launch
    with: the launch is refused and the wrappers raise, with no launch
    counted and nothing run in another form."""
    pos, vel, radius, gm = _inputs(cuda, 4096, 3000, seed=12)
    before = (df.LAUNCHES, rf.LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError"):
        df.fused_substep(0.01, pos, vel, radius, gm, plan=(2, 16))
    with pytest.raises(RuntimeError, match="cudaError"):
        rf.ring_hop(pos, radius, pos, gm, torch.zeros_like(pos),
                    accumulate=False, plan=(2, 16))
    assert (df.LAUNCHES, rf.LAUNCHES) == before
    # the card is still usable
    assert torch.isfinite(df.force_acc(pos, radius, pos[:3000], gm)).all()


# --- K4: the P3M pair correction ---

def _random_blocks(device, gc=8, cap=32, seed=0):
    """Random cells: slot positions inside their own cell of a unit grid,
    radii 0.5-9.5 and gm 10-1e4 in a random number of live slots."""
    rng = np.random.default_rng(seed)
    counts_t = rng.integers(0, cap + 1, gc * gc).astype(np.int32)
    counts_s = rng.integers(0, cap + 1, gc * gc).astype(np.int32)
    ij = np.stack(np.meshgrid(np.arange(gc), np.arange(gc), indexing="ij"), -1)
    cell = 4.0

    def slots(counts):
        xy = (ij[:, :, None, :] + rng.uniform(size=(gc, gc, cap, 2))) * cell
        live = np.arange(cap)[None, :] < counts[:, None]
        return xy.astype(np.float32), live.reshape(gc, gc, cap)

    txy, _ = slots(counts_t)
    sxy, live_s = slots(counts_s)
    tr = rng.uniform(0.5, 9.5, (gc, gc, cap)).astype(np.float32)
    sg = np.where(live_s, rng.uniform(10, 1e4, (gc, gc, cap)), 0).astype(np.float32)
    arrays = (txy[..., 0], txy[..., 1], tr, sxy[..., 0], sxy[..., 1], sg)
    blocks = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
    counts = [torch.from_numpy(c).to(device) for c in (counts_t, counts_s)]
    return blocks, cell, counts


def _galaxy_blocks(device, n=20_000, grid=512, cap=96):
    """The blocks a p3m world packs for a two-galaxy scene."""
    w = nt.create_world(nt.make_galaxies(n, 2, seed=11037), device=device)
    pos, rad, gm = w.state.pos, w.state.radius, w.gm
    bins = p3m_forces.p3m_bins(pos, rad, pos[:w.mass_len], gm, grid=grid,
                               rc_cells=4, exact_targets=0)
    gc = grid // 4
    src = p3m_forces._pack_source_blocks(pos[:w.mass_len], gm,
                                         bins["order_s"], bins["counts_s"],
                                         gc, cap)
    trow = torch.cat([pos, rad[:, None]], -1)[bins["order_t"]]
    tgt = p3m_forces._gather_blocks(
        [(trow[:, 0], 0.0), (trow[:, 1], 0.0), (trow[:, 2], 1.0)],
        bins["counts_t"], gc, cap)
    return [*tgt, *src], float(4 * bins["h"]), [bins["counts_t"], bins["counts_s"]]


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("scene", ["random", "galaxies"])
def test_pp_blocks_matches_plain(cuda, scene, precise, counts):
    """K4 against its plain version on the same blocks: fp32 sums of at
    most 9·cap terms in another order, FMA contraction and the hardware
    rsqrt; a pair on the rc boundary may flip (see test_torch_p3m.py).
    Bound 1e-5 of max|ref|."""
    if scene == "random":
        blocks, rc, cnt = _random_blocks(cuda)
    else:
        blocks, rc, cnt = _galaxy_blocks(cuda)
    kw = dict(counts_t=cnt[0], counts_s=cnt[1]) if counts else {}
    before = p3m_pp.LAUNCHES
    got = p3m_pp.pp_blocks(*blocks, rc, 4.0, precise=precise, **kw)
    assert p3m_pp.LAUNCHES == before + 1
    want = p3m_pp.pp_blocks_plain(*blocks, rc, 4.0, precise=precise, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


def test_pp_blocks_zero_counts_write_zeros(cuda):
    blocks, rc, cnt = _random_blocks(cuda)
    zero = torch.zeros_like(cnt[0])
    got = p3m_pp.pp_blocks(*blocks, rc, 4.0, counts_t=zero)
    assert torch.equal(got, torch.zeros_like(got))


def _random_cells(device, gc=8, cap=32, seed=0):
    """Random cells of size 4 in cell order (rows, starts, counts of both
    sides) and the sorted targets' radii: 0 to cap + 8 rows a cell, cell 0
    without targets, cell 1 at cap, cell 2 past it."""
    rng = np.random.default_rng(seed)
    counts = [rng.integers(0, cap + 9, gc * gc).astype(np.int32)
              for _ in range(2)]
    counts[0][:3] = (0, cap, cap + 5)
    rows = []
    for c, lo, hi in ((counts[0], 0.5, 9.5), (counts[1], 10.0, 1e4)):
        cell = np.repeat(np.arange(gc * gc), c)
        xy = (np.stack([cell // gc, cell % gc], 1)
              + rng.uniform(size=(len(cell), 2))) * 4.0
        w = rng.uniform(lo, hi, len(cell))
        rows.append(np.concatenate([xy, w[:, None], np.zeros((len(cell), 1))],
                                   1).astype(np.float32))
    radius = torch.from_numpy(rows[0][:, 2].copy()).to(device)
    rows[0][:, 2] += np.float32(p3m_pp.SOFTENING_FLOOR)
    t = [torch.from_numpy(a).to(device) for a in (*rows, *counts)]
    starts = [torch.cumsum(c, 0, dtype=torch.int32) - c for c in t[2:]]
    return [t[0], t[1], starts[0], t[2], starts[1], t[3]], 4.0, radius


def _galaxy_cells(device, n=20_000, grid=512):
    """The rows and runs a p3m world hands K4 for a two-galaxy scene."""
    w = nt.create_world(nt.make_galaxies(n, 2, seed=11037), device=device)
    pos, rad, gm = w.state.pos, w.state.radius, w.gm
    src = pos[:w.mass_len]
    bins = p3m_forces.p3m_bins(pos, rad, src, gm, grid=grid, rc_cells=4,
                               exact_targets=0)
    cells = [p3m_forces._cell_rows(pos, rad + p3m_pp.SOFTENING_FLOOR,
                                   bins["order_t"]),
             p3m_forces._cell_rows(src, gm, bins["order_s"]),
             bins["start_t"], bins["counts_t"], bins["start_s"],
             bins["counts_s"]]
    return cells, float(4 * bins["h"]), rad[bins["order_t"]]


def _cells_scene(scene, device, cap):
    if scene == "random":
        return _random_cells(device, cap=cap)
    return _galaxy_cells(device)


def _cells_as_blocks(cells, radius, cap):
    """The (gc, gc, cap) blocks of the same cells for pp_blocks, and each
    slot's row and whether it is live."""
    gc = int(round(cells[3].numel() ** 0.5))
    blocks = []
    for vals, start, counts, fills in (
            ([cells[0][:, 0], cells[0][:, 1], radius], cells[2], cells[3],
             (0.0, 0.0, 1.0)),
            ([cells[1][:, 0], cells[1][:, 1], cells[1][:, 2]], cells[4],
             cells[5], (0.0, 0.0, 0.0))):
        idx, live = p3m_pp.run_slots(start, counts, cap, len(vals[0]))
        idx = idx.clamp(max=len(vals[0]) - 1)
        blocks += [torch.where(live, v[idx], f).reshape(gc, gc, cap)
                   .contiguous() for v, f in zip(vals, fills)]
    idx, live = p3m_pp.run_slots(cells[2], cells[3], cap, len(cells[0]))
    return blocks, idx, live


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("scene", ["random", "galaxies"])
def test_pp_cells_matches_plain(cuda, scene, precise):
    """K4 on the cells route against pp_cells_plain, one launch a call.
    Bound 1e-5 of max|ref|, pp_blocks' (same sums, same reasons)."""
    cells, rc, _ = _cells_scene(scene, cuda, 32)
    before = p3m_pp.LAUNCHES
    got = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=32, cap_s=32,
                          precise=precise)
    assert p3m_pp.LAUNCHES == before + 1
    want = p3m_pp.pp_cells_plain(*cells, rc, 4.0, cap_t=32, cap_s=32,
                                 precise=precise)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("scene", ["random", "galaxies"])
def test_pp_cells_rows_equal_pp_blocks(cuda, scene, precise):
    """The same kernel on the rows and on the blocks of the same cells:
    each live target sums the same pairs in the same order, bit for bit."""
    cells, rc, radius = _cells_scene(scene, cuda, 32)
    blocks, idx, live = _cells_as_blocks(cells, radius, 32)
    got = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=32, cap_s=32,
                          precise=precise)
    per_slot = p3m_pp.pp_blocks(*blocks, rc, 4.0, precise=precise,
                                counts_t=cells[3], counts_s=cells[5])
    assert torch.equal(got[idx[live]], per_slot[live])


def test_pp_cells_overflow_empty_and_full_cells(cuda):
    """Rows past a cell's cap are 0; a full cell's rows and the rows beside
    an empty cell are computed; two calls give the same bits."""
    cells, rc, _ = _random_cells(cuda)
    got = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=32, cap_s=32)
    again = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=32, cap_s=32)
    assert torch.equal(got, again)
    start, counts = cells[2].long(), cells[3].long()
    cell = torch.repeat_interleave(torch.arange(len(counts), device=cuda),
                                   counts)
    rank = torch.arange(len(cell), device=cuda) - start[cell]
    over = rank >= 32
    assert int(over.sum()) >= 5
    assert torch.equal(got[over], torch.zeros_like(got[over]))
    assert (got[cell == 1] != 0).any(1).all()      # the cell at cap
    want = p3m_pp.pp_cells_plain(*cells, rc, 4.0, cap_t=32, cap_s=32)
    assert rel_err(got.cpu(), want.cpu()) < TOL


def test_pp_cells_galaxy_overflow_rows_are_zero(cuda):
    """Cap 8 on the galaxy cells: the rows past a cell's cap are exactly
    0, the rest within 1e-5 of the plain version."""
    cells, rc, _ = _galaxy_cells(cuda)
    got = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=8, cap_s=8)
    idx, live = p3m_pp.run_slots(cells[2], cells[3], 8, len(cells[0]))
    assert int(live.sum()) < len(cells[0])
    kept = torch.zeros(len(cells[0]), dtype=torch.bool, device=cuda)
    kept[idx[live]] = True
    assert torch.equal(got[~kept], torch.zeros_like(got[~kept]))
    want = p3m_pp.pp_cells_plain(*cells, rc, 4.0, cap_t=8, cap_s=8)
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_world_p3m_on_the_card(cuda, integrator):
    """The p3m world on the card (K4 and the split force_acc) against the
    same scene's plain path on the CPU, 5 substeps. The card's FFT is
    cuFFT, so the mesh force differs from the CPU's at fp32 noise. Bounds:
    pos 1e-6, vel and acc 2e-5 of max, the CPU-vs-JAX tolerances of
    test_torch_p3m.py."""
    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=32,
                       integrator=integrator)
    scene = nt.make_galaxies(4000, 2, seed=11037)
    w_k = nt.create_world(scene, config=cfg, device=cuda)
    w_p = nt.create_world(scene, config=cfg, device="cpu")
    df.LAUNCHES = p3m_pp.LAUNCHES = 0
    w_k.update(0.01, 5, backend="p3m")
    assert (df.LAUNCHES, p3m_pp.LAUNCHES) == (5, 5)
    w_p.update(0.01, 5, backend="p3m")
    for name, tol in (("pos", 1e-6), ("vel", 2e-5), ("acc", 2e-5)):
        got, want = getattr(w_k.particles, name), getattr(w_p.particles, name)
        assert torch.isfinite(got).all()
        assert rel_err(got, want) < tol, name


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_mesh_world_two_runs_are_bit_equal(cuda, backend):
    """The mesh path sums its CIC scatter in a fixed order, so two runs
    from the same state give the same bits."""
    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=32)
    scene = nt.make_galaxies(20_000, 2, seed=11037)
    runs = []
    for _ in range(2):
        w = nt.create_world(scene, config=cfg, device=cuda)
        w.update(0.01, 5, backend=backend)
        runs.append(w.particles)
    for name in ("pos", "vel", "acc"):
        got = getattr(runs[0], name)
        assert torch.isfinite(got).all(), name
        assert torch.equal(got, getattr(runs[1], name)), name


# --- K5a, K5g, K5d, K5h: the direct-force variants of the ablation path ---

def _scene(device, n):
    from nbody_tpu_torch.ablations import _scene as sc

    return sc.make_scene(n, device=device)


def _twice(call):
    """call() twice: the first result, and whether the two are bit-equal."""
    a, b = call(), call()
    torch.cuda.synchronize()
    a = a if isinstance(a, torch.Tensor) else torch.cat(a)
    b = b if isinstance(b, torch.Tensor) else torch.cat(b)
    return a, torch.equal(a, b)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("block,chunk", [(256, 2048), (128, 512), (512, 4096)])
def test_v2_acc_matches_plain(cuda, block, chunk, precise):
    sc = _scene(cuda, 4096)
    src = sc.src3(sc.s128)
    before = rsf.LAUNCHES
    got, same = _twice(lambda: rsf.v2_acc(sc.pos, sc.radius, src, block=block,
                                          chunk=chunk, precise=precise))
    assert rsf.LAUNCHES == before + 2 and same
    want = rsf.v2_acc_plain(sc.pos, sc.radius, src, precise=precise)
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("p,block,chunk,n_split", [
    (1, 256, 2048, None), (4, 256, 2048, None), (4, 256, 2048, 1),
    (8, 128, 1024, None), (2, 512, 512, 3)])
def test_ptile_acc_matches_plain(cuda, p, block, chunk, n_split):
    sc = _scene(cuda, 4096)
    tgt, src = sc.tgt3(), sc.src3(sc.s128)
    before = ptf.LAUNCHES
    got, same = _twice(lambda: ptf.ptile_acc(tgt, src, p=p, block=block,
                                             chunk=chunk, n_split=n_split))
    assert ptf.LAUNCHES == before + 2 and same
    want = torch.cat(ptf.ptile_acc_plain(tgt, src))
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("block,chunk,slabs", [(256, 128, None), (256, 512, 1),
                                               (512, 2048, None), (128, 256, 7)])
def test_stationary_acc_matches_plain(cuda, block, chunk, slabs, precise):
    sc = _scene(cuda, 4096)
    tgt = sc.tgt3()
    src = sc.src3(-(-sc.mass_len // chunk) * chunk)
    before = stf.LAUNCHES
    got, same = _twice(lambda: stf.stationary_acc(
        tgt, src, block=block, chunk=chunk, slabs=slabs, precise=precise))
    assert stf.LAUNCHES == before + 2 and same
    want = stf.stationary_acc_plain(tgt, src, chunk=chunk, precise=precise)
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("n", [20_000, 5_000])
def test_newton_acc_matches_plain_and_direct_sum(cuda, n, tile):
    """The Newton kernel against its plain version (the same schedule) and
    against the plain direct sum; N=5000 has mass_len and N ragged against
    every tile width."""
    sc = _scene(cuda, n)
    tgt, src = sc.tgt4(), sc.src4(sc.s128)
    before = nwf.LAUNCHES
    got, same = _twice(lambda: nwf.newton_acc(tgt, src, sc.mass_len, tile=tile))
    assert nwf.LAUNCHES == before + 2 and same
    assert torch.isfinite(got).all()
    want = torch.cat(nwf.newton_acc_plain(tgt, src, sc.mass_len, tile=tile))
    assert rel_err(got.cpu(), want.cpu()) < TOL
    assert rel_err(got.T.cpu(), sc.control().cpu()) < TOL


# --- K5b, K5e, K5c, K5f, K5i: the flavored chunk kernel and the probes ---

def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("flavor,p,rows", [
    *((f, 1, True) for f in ff.FLAVORS if f not in ("rows", "control", "full")),
    *((f, p, False) for f in ("base", "unroll2", "static", "partial")
      for p in (1, 2)),
    *((f, p, True) for f in ("partial", "fma_kloop", "f_assoc", "static")
      for p in (4, 8)),
])
def test_flavor_acc_matches_plain(cuda, flavor, p, rows):
    """Every variant against its plain version on the N=4096 scene with
    2049 source rows in chunks of 1024 (a last chunk of one source), twice
    bit-equal. Bound TOL: the plain version follows the kernel's
    association but sums each run in its own order."""
    sc = _scene(cuda, 4096)
    tgt = sc.tgt3() if rows else (sc.pos, sc.radius)
    src = sc.src3(sc.mass_len + 37)
    before = ff.LAUNCHES
    got, same = _twice(lambda: ff.flavor_acc(tgt, src, flavor=flavor, p=p,
                                             block=256, chunk=1024))
    assert ff.LAUNCHES == before + 2 and same
    want = ff.flavor_acc_plain(tgt, src, flavor=flavor, p=p, chunk=1024)
    want = torch.cat(want) if rows else want
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("expr", op.EXPRS)
def test_op_probe_matches_plain(cuda, expr):
    """Each expression at 4099 loops (512 passes of 8 and a remainder of
    3): add and mul bit-equal to the plain chain, the others within the
    bounds of the ablation module (set at 4096 loops, where sq_chain's
    diverging elements have reached inf)."""
    from nbody_tpu_torch.ablations import tune_r2f

    x, y = (t[:64, :300].contiguous() for t in tune_r2f.inputs(expr, cuda))
    before = op.LAUNCHES
    got, again = (op.op_probe(x, y, expr=expr, loops=4099) for _ in range(2))
    assert op.LAUNCHES == before + 2 and _bits_equal(got, again)
    want = op.op_probe_plain(x, y, expr=expr, loops=4099)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    if tune_r2f.BOUNDS[expr] == 0:
        assert _bits_equal(got, want)
    else:
        assert rel_err(got[fin].cpu(), want[fin].cpu()) < tune_r2f.BOUNDS[expr]


@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("variant", bp.VARIANTS)
def test_bcast_acc_matches_plain(cuda, variant, n_split):
    """Each broadcast on 300 targets (a ragged block) and 1024 sources,
    5 sweeps, with the script's NaN-making third row: NaN where the plain
    version has NaN, the finite entries within 5e-6, twice bit-equal."""
    rng = np.random.RandomState(0)
    tgt = torch.from_numpy(rng.randn(3, 300).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.randn(3, 1024).astype(np.float32)).to(cuda)
    splits = n_split or bp.split_plan(300, 5, df.sm_count(cuda.index or 0))
    before = bp.LAUNCHES
    got, again = (bp.bcast_acc(tgt, src, variant=variant, reps=5,
                               n_split=n_split) for _ in range(2))
    assert bp.LAUNCHES == before + 2 and _bits_equal(got, again)
    want = bp.bcast_acc_plain(tgt, src, reps=5, n_split=splits)
    fin = torch.isfinite(want)
    assert 0 < int(fin.sum()) < fin.numel()
    assert torch.equal(torch.isfinite(got), fin)
    assert rel_err(got[fin].cpu(), want[fin].cpu()) < 5e-6


# --- K3: the ring hop and the sharded world ---

@pytest.mark.parametrize("n_src", [333, 0])
@pytest.mark.parametrize("last,pos_dt", [(False, 1.0), (True, 1.0), (True, 0.5)])
@pytest.mark.parametrize("precise", [True, False])
def test_ring_hop_matches_plain(cuda, precise, last, pos_dt, n_src):
    """The hop kernel against its plain version: a middle hop adds into the
    running sum; the last hop's epilogue is held to the plain update of the
    kernel's own force. The slot holds 400 rows; the kernel stops at
    n_src."""
    pos, vel, radius, gm = _inputs(cuda, 1000, 400)
    valid = (torch.arange(1000, device=cuda) < 990).float()
    run0 = df.force_acc_plain(pos, radius, pos[:50], gm[:50])
    src_gm = gm[:n_src]
    kw = dict(vel=vel, valid=valid, dt=0.01, pos_dt=pos_dt) if last else {}
    run_k, run_p = run0.clone(), run0.clone()
    before = rf.LAUNCHES
    got = rf.ring_hop(pos, radius, pos[:400], src_gm, run_k, accumulate=True,
                      precise=precise, **kw)
    assert rf.LAUNCHES == before + 1
    want = rf.ring_hop_plain(pos, radius, pos[:400], src_gm, run_p,
                             accumulate=True, precise=precise, **kw)
    torch.cuda.synchronize()
    if not last:
        assert rel_err(run_k.cpu(), run_p.cpu()) < TOL
        return
    npos, nvel, acc = got
    assert torch.equal(run_k, run0)
    assert rel_err(acc.cpu(), want[2].cpu()) < TOL
    assert torch.equal(acc[990:], torch.zeros_like(acc[990:]))
    assert rel_err(nvel.cpu(), (vel + 0.01 * acc).cpu()) < EPILOGUE_TOL
    assert rel_err(npos.cpu(), (pos + df._pos_dt_times_dt(pos_dt, 0.01)
                                * nvel).cpu()) < EPILOGUE_TOL


def _sharded(cuda, d, backend, n=20_000, integrator="euler", serial=False):
    w = ShardedWorld(nt.make_galaxies(n, 2, seed=11037),
                     make_mesh(devices=[cuda] * d),
                     config=nt.SimConfig(integrator=integrator),
                     force_backend=backend)
    w.ring.serial = serial
    return w


@pytest.mark.parametrize("backend", ["cuda_ring", "cuda"])
def test_ring_overlapped_is_bit_equal_to_serial(cuda, backend):
    """Four shards on one card, their streams overlapping, against the same
    kernel with the card synchronised after every hop and copy (a schedule
    that cannot race): any difference is a race. "cuda" (the direct
    kernel per hop, the default on CUDA shards) walks the same schedule."""
    counter = rf if backend == "cuda_ring" else df
    a = _sharded(cuda, 4, backend)
    b = _sharded(cuda, 4, backend, serial=True)
    counter.LAUNCHES = 0
    a.update(0.01, 5)
    assert counter.LAUNCHES == 5 * 16
    b.update(0.01, 5)
    for name in ("pos", "vel", "acc"):
        got = getattr(a.particles, name)
        assert torch.isfinite(got).all(), name
        assert torch.equal(got, getattr(b.particles, name)), name


@pytest.mark.parametrize("backend,per_stage", [("cuda_ring", 16), ("cuda", 16)])
@pytest.mark.parametrize("integrator,stages", [("euler", 1), ("yoshida4", 3)])
def test_sharded_world_matches_world(cuda, backend, per_stage, integrator, stages):
    """Four shards on one card against the single-device World on "cuda",
    5 substeps: the per-hop sums differ from one sum over all sources in
    order only."""
    w = _sharded(cuda, 4, backend, n=2000, integrator=integrator)
    ref = nt.create_world(nt.make_galaxies(2000, 2, seed=11037),
                          config=nt.SimConfig(integrator=integrator), device=cuda)
    rf.LAUNCHES = df.LAUNCHES = 0
    w.update(0.01, 5)
    counted = rf.LAUNCHES if backend == "cuda_ring" else df.LAUNCHES
    assert counted == 5 * stages * per_stage
    ref.update(0.01, 5)
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w.particles, name), getattr(ref.particles, name)
        assert torch.isfinite(got).all()
        assert rel_err(got, want) < TOL, name


# --- force hooks and adaptive dt on the card ---

def _drag(pos, vel):
    return -0.1 * vel


@pytest.mark.parametrize("integrator,stages", [("euler", 1), ("yoshida4", 3)])
def test_hooked_world_cuda_matches_torch_backend(cuda, integrator, stages):
    """A hook takes "cuda" off its fused launch: one force_acc a stage,
    then the hook and the integration in PyTorch; against the plain
    "torch" backend on the card."""
    p = nt.make_galaxies(2000, 2, seed=11037)
    cfg = nt.SimConfig(integrator=integrator)
    w_k = nt.create_world(p, config=cfg, device=cuda)
    w_p = nt.create_world(p, config=cfg, device=cuda)
    df.LAUNCHES = 0
    w_k.update(0.01, 5, extra_force=_drag)
    assert df.LAUNCHES == 5 * stages
    w_p.update(0.01, 5, backend="torch", extra_force=_drag)
    assert df.LAUNCHES == 5 * stages
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w_k.particles, name), getattr(w_p.particles, name)
        assert rel_err(got, want) < TOL, name


def _adaptive_launches(k: int, stages: int, batch: int) -> int:
    """Force evaluations of update_adaptive: the priming substep, then
    whole batches until the one that reaches t_span."""
    return stages * (1 + batch * -(-k // batch))


@pytest.mark.parametrize("integrator,stages", [("euler", 1), ("leapfrog", 1)])
def test_adaptive_cuda_matches_torch_backend(cuda, monkeypatch, integrator,
                                             stages):
    """update_adaptive on "cuda" and on the plain "torch" backend from the
    same state take the same substeps; the batch makes no host sync (the
    sync debug mode raises on any but the loop's own flag and count
    reads)."""
    from nbody_tpu_torch import world as world_mod

    def lifted(x):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return x.item()
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    p = nt.make_galaxies(2000, 2, seed=11037)
    cfg = nt.SimConfig(integrator=integrator)
    w_k = nt.create_world(p, config=cfg, device=cuda)
    w_p = nt.create_world(p, config=cfg, device=cuda)
    monkeypatch.setattr(world_mod, "_host", lifted)
    df.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        k = w_k.update_adaptive(0.05, dt_max=0.01)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert df.LAUNCHES == _adaptive_launches(k, stages, world_mod.ADAPTIVE_BATCH)
    assert w_p.update_adaptive(0.05, dt_max=0.01, backend="torch") == k
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w_k.particles, name), getattr(w_p.particles, name)
        assert torch.isfinite(got).all()
        assert rel_err(got, want) < TOL, name


@pytest.mark.parametrize("backend", ["cuda_ring", "cuda"])
def test_hooked_and_adaptive_sharded_match_world(cuda, backend):
    """Four shards on one card, hooked and adaptive, against the World:
    the hop kernel without its epilogue (D² launches a substep) or the
    direct kernel per hop; the same adaptive count."""
    counter = rf if backend == "cuda_ring" else df
    w = _sharded(cuda, 4, backend, n=2000)
    ref = nt.create_world(nt.make_galaxies(2000, 2, seed=11037), device=cuda)
    counter.LAUNCHES = 0
    w.update(0.01, 5, extra_force=_drag)
    assert counter.LAUNCHES == 5 * 16
    ref.update(0.01, 5, extra_force=_drag)
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w.particles, name), getattr(ref.particles, name)
        assert rel_err(got, want) < TOL, name
    assert w.update_adaptive(0.03, dt_max=0.01) == ref.update_adaptive(
        0.03, dt_max=0.01)


def test_diagnostics_on_the_card_match_the_cpu(cuda):
    from nbody_tpu_torch import diagnostics

    p = nt.make_galaxies(4000, 2, seed=11037)
    w_k = nt.create_world(p, device=cuda)
    w_c = nt.create_world(p, device="cpu")
    w_k.update(0.01, 2, backend="torch")
    w_c.update(0.01, 2, backend="torch")
    got, want = diagnostics.summary(w_k), diagnostics.summary(w_c)
    for key in ("kinetic_energy", "potential_energy", "angular_momentum",
                "suggested_dt"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    u = float(diagnostics.potential_energy(w_k.state, w_k.mass_len))
    u_pm = float(diagnostics.potential_energy_pm(w_k.state, w_k.mass_len,
                                                 grid=256))
    assert abs(u_pm - u) / abs(u) < 0.02


# --- the contact kernel of the merge pass (csrc/merge_contacts.cu) ----------

def _contact_scene(kind, device):
    """(pos, radius, mass, live) of the merge pass's edge cases: ties of
    equal masses, a chain, pairs exactly on the boundary, dead rows, and a
    row count that is no multiple of the kernel's 256-row tile."""
    rng = np.random.default_rng(5)
    if kind == "chain":
        n = 700
        pos = np.stack([np.arange(n) * 1.0, np.zeros(n)], 1)
        mass = np.arange(1, n + 1) % 37 + 1.0          # ties along the line
        radius = np.full(n, 0.6)
    elif kind == "boundary":
        n = 513
        pos = np.stack([np.arange(n) * 1.0, np.zeros(n)], 1)  # d = r_i + r_j
        mass = np.full(n, 2.0)
        radius = np.full(n, 0.5)
        pos[7] = (7.0, 0.75)                                  # and two overlaps
        pos[300] = (300.25, 0.0)
    else:
        n = {"cluster": 1100, "ties": 4097}[kind]
        pos = rng.uniform(-14, 14, (n, 2)) * (n / 1100) ** 0.5
        mass = rng.uniform(0.5, 2.0, n)
        if kind == "ties":
            mass = np.round(mass * 4) / 4                    # many equal masses
        radius = np.full(n, 0.4)
    live = rng.uniform(size=n) > 0.05
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
         for a in (pos, radius, mass)]
    return (*t, torch.from_numpy(live).to(device))


@pytest.mark.parametrize("kind", ["cluster", "ties", "chain", "boundary"])
@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_contacts_kernel_is_bit_equal_to_plain(cuda, kind, factor):
    pos, radius, mass, live = _contact_scene(kind, cuda)
    col.LAUNCHES = 0
    got = col.contacts(pos, radius, mass, live, factor)
    want = col.contacts_plain(pos, radius, mass, live, factor)
    torch.cuda.synchronize()
    assert col.LAUNCHES == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("plan", [(1, 5), (2, 3), (5, 1)])
def test_contacts_kernel_any_split_is_the_same(cuda, plan):
    pos, radius, mass, live = _contact_scene("cluster", cuda)  # 5 tiles
    want = col.contacts(pos, radius, mass, live, 1.0, plan=(1, 5))
    got = col.contacts(pos, radius, mass, live, 1.0, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_contacts_kernel_refuses_a_bad_plan(cuda):
    pos, radius, mass, live = _contact_scene("cluster", cuda)
    with pytest.raises(ValueError, match="plan"):
        col.contacts(pos, radius, mass, live, 1.0, plan=(3, 1))


def test_merge_pass_on_the_card_is_bit_equal_to_plain_and_repeats(cuda):
    pos, radius, mass, live = _contact_scene("ties", cuda)
    vel = torch.randn(pos.shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    gm = torch.where(live, 10.0 * mass, 0.0)
    a = col.merge_pass(pos, vel, radius, mass, gm, factor=1.0, g=10.0)
    b = col.merge_pass(pos, vel, radius, mass, gm, factor=1.0, g=10.0)
    c = col.merge_pass_plain(pos, vel, radius, mass, gm, factor=1.0, g=10.0)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_merging_world_on_the_card_matches_torch_and_makes_no_sync(cuda):
    rng = np.random.default_rng(2)
    n = 2000
    p = nt.make_particles(rng.uniform(-20, 20, (n, 2)).astype(np.float32),
                          vel=rng.normal(0, 0.2, (n, 2)).astype(np.float32),
                          mass=rng.uniform(0.5, 2.0, n).astype(np.float32),
                          radius=np.full(n, 0.4, np.float32))
    cfg = nt.SimConfig(merge_collisions=True)
    w = nt.create_world(p, config=cfg, device=cuda)
    ref = nt.create_world(p, config=cfg, device=cuda)
    col.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        w.update(1e-3, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref.update(1e-3, 10, backend="torch")
    assert col.LAUNCHES == 20   # the "torch" backend's pass launches too
    a, b = w.particles, ref.particles
    assert torch.equal(a.mass, b.mass) and int((a.mass == 0).sum()) > 0
    assert rel_err(a.pos, b.pos) < 1e-5
    np.testing.assert_allclose(w.gm.cpu().numpy(),
                               10.0 * a.mass[:w.mass_len].numpy(), rtol=1e-6)
