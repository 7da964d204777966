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
from nbody_tpu_torch.ops import v2_forces as v2
from nbody_tpu_torch.ops import p3m_forces, p3m_pp
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.utils import contact_scenes

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


@pytest.mark.parametrize("backend", ["cuda", "p3m"])
def test_tracer_on_the_card(cuda, backend):
    """The tracer on the card: world.update > substep > k1.launch (the
    fused substep; "p3m": under p3m.exact_rows), the loads in
    _build.LOADED, no sync inside the traced update (the device counters
    wait for collect()), and the P3M counters equal to a count from the
    bins of the same positions."""
    from nbody_tpu_torch import world as world_mod
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.utils import profiling

    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=16)
    w = nt.create_world(nt.make_galaxies(20_000, 2, seed=11037), config=cfg,
                        default_backend=backend, device=cuda)
    w.update(0.01, 1)
    assert _build.LOADED and all(s > 0 for s in _build.LOADED.values())
    st, s_rows = w.state, world_mod._mesh_sources(w.gm).shape[0]
    bins = p3m_forces.p3m_bins(
        st.pos, st.radius, st.pos[:s_rows], world_mod._mesh_sources(w.gm),
        grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
        exact_targets=cfg.p3m_exact_targets)
    torch.cuda.synchronize()
    profiling.collect()
    profiling.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w.update(0.01, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
    rec = profiling.collect()
    spans = rec["spans"]
    path = {"cuda": ["world.update", "substep", "k1.launch"],
            "p3m": ["world.update", "substep", "p3m.exact_rows",
                    "k1.launch"]}[backend]
    launch = next(s for s in spans if s.name == "k1.launch")
    chain, s = [], launch
    while True:
        chain.append(s.name)
        if s.parent < 0:
            break
        s = spans[s.parent]
    assert chain[::-1] == path
    assert launch.step == 0
    if backend == "p3m":
        def past(counts):
            return int(torch.clamp_min(counts - 16, 0).sum())
        assert rec["counts"] == {
            "p3m.targets": w.total_len, "p3m.sources": s_rows,
            "p3m.dropped_targets": past(bins["counts_t"]),
            "p3m.dropped_sources": past(bins["counts_s"])}


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
@pytest.mark.parametrize("extra", [None, 37])
@pytest.mark.parametrize("block,chunk", [(256, 2048), (128, 512), (512, 4096),
                                         (1024, 1024), (512, 8192)])
def test_v2_acc_matches_plain(cuda, block, chunk, precise, extra):
    """K5a (``csrc/v2_forces.cu``, column layout) at tiles of one and two
    targets a thread, both paths, against the plain direct sum: S128 rows
    (16-byte copies) or mass_len + 37 (4-byte copies, a ragged chunk and
    run), chunk 8192 longer than S (one chunk), twice bit-equal, one K5a
    launch a call and none of K5b's; unsplit, the same bits whatever the
    chunk (runs of 256 restart at each chunk, and every chunk here is a
    whole number of runs)."""
    sc = _scene(cuda, 4096)
    src = sc.src3(sc.s128 if extra is None else sc.mass_len + extra)
    before = (rsf.LAUNCHES, v2.LAUNCHES)
    got, same = _twice(lambda: rsf.v2_acc(sc.pos, sc.radius, src, block=block,
                                          chunk=chunk, precise=precise))
    assert (rsf.LAUNCHES, v2.LAUNCHES) == (before[0] + 2, before[1]) and same
    want = rsf.v2_acc_plain(sc.pos, sc.radius, src, precise=precise)
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL
    one, other = (rsf.v2_acc(sc.pos, sc.radius, src, block=block, chunk=c,
                             precise=precise, n_split=1) for c in (chunk, 256))
    assert torch.equal(one, other)


def test_v2_acc_launch_error_raises(cuda, monkeypatch):
    """A failed K5a launch on CUDA tensors raises and counts nothing."""
    sc = _scene(cuda, 4096)

    class Failing:
        def nbody_v2_forces(self, *args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(v2, "_lib", Failing)
    before = rsf.LAUNCHES
    with pytest.raises(RuntimeError, match="K5a"):
        rsf.v2_acc(sc.pos, sc.radius, sc.src3(sc.s128), precise=True)
    assert rsf.LAUNCHES == before


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


@pytest.mark.parametrize("n,p,block,chunk,n_split", [
    (4000, 4, 256, 1100, None), (4001, 8, 128, 1027, 3), (4000, 1, 96, 300, None),
    (4001, 2, 256, 12287, 2), (4000, 8, 64, 1536, None), (4001, 2, 512, 13, 1),
    (4000, 4, 896, 2048, None), (4001, 8, 512, 4096, 1)])
def test_ptile_acc_ragged_stages_match_plain(cuda, n, p, block, chunk, n_split):
    """K5g where a chunk is not a whole number of stages or of batches of 8
    (1100 and 12287: stages of 1024 and a short last one; 1027, 300 and 13:
    one stage a chunk, a ragged last batch; 1536: stages of 512) and T is
    not a whole number of blocks (P * block targets), the sources ragged
    too (mass_len + 37 rows), up to the largest blocks the kernel's
    registers allow (896 threads at P = 4, 512 at P = 8): against its
    plain version (TOL), twice bit-equal, one launch a call."""
    sc = _scene(cuda, n)
    tgt, src = sc.tgt3(), sc.src3(sc.mass_len + 37)
    before = ptf.LAUNCHES
    got, same = _twice(lambda: ptf.ptile_acc(tgt, src, p=p, block=block,
                                             chunk=chunk, n_split=n_split))
    assert ptf.LAUNCHES == before + 2 and same
    assert torch.isfinite(got).all()
    want = torch.cat(ptf.ptile_acc_plain(tgt, src))
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("chunk,stages", [(2048, (256, 512, 1024, 2048)),
                                          (1100, (256, 1024, 1100)),
                                          (1032, (256, 512, 1032))])
def test_sweep_sums_do_not_depend_on_the_stage(cuda, monkeypatch, chunk, stages):
    """K5g and every K5e flavor at P = 2 give the same bits at every stage
    the C entries take for the chunk (a multiple of 256 below it, or the
    whole chunk; ``ptile_forces.stage`` forced): the runs and chains carry
    from stage to stage. K5e takes chunks of whole batches only, so the
    chunk of 1100 is K5g's alone."""
    sc = _scene(cuda, 4096)
    tgt, src = sc.tgt3(), sc.src3(sc.mass_len + 37)
    calls = {"K5g": lambda: ptf.ptile_acc(tgt, src, p=2, block=256,
                                          chunk=chunk, n_split=2)}
    for flavor in ff.FLAVORS if chunk % 8 == 0 else ():
        calls[flavor] = lambda flavor=flavor: ff.flavor_acc(
            tgt, src, flavor=flavor, p=2, block=256, chunk=chunk)
    for name, call in calls.items():
        outs = []
        for st in stages:
            monkeypatch.setattr(ptf, "stage", lambda c, st=st: st)
            outs.append(torch.cat(call()))
        torch.cuda.synchronize()
        assert all(_bits_equal(outs[0], o) for o in outs[1:]), name


def test_k5g_k5e_stage_the_same_on_both_entry_points(cuda, monkeypatch):
    """Both C entries get ``ptile_forces.stage(chunk)`` as their stage
    argument (read off the calls), at chunks of one, several and a ragged
    number of stages."""
    sc = _scene(cuda, 4096)
    tgt, src = sc.tgt3(), sc.src3(sc.s128)
    seen = []

    class Spy:
        def __init__(self, lib, index):
            self.lib, self.index = lib, index

        def __getattr__(self, name):
            fn = getattr(self.lib, name)
            return lambda *a: seen.append((name, a[self.index])) or fn(*a)

    lib_g, lib_e = ptf._lib(), ff._lib()
    monkeypatch.setattr(ptf, "_lib", lambda: Spy(lib_g, 7))
    monkeypatch.setattr(ff, "_lib", lambda: Spy(lib_e, 8))
    for chunk in (512, 2048, 1032):
        ptf.ptile_acc(tgt, src, p=2, block=256, chunk=chunk)
        ff.flavor_acc(tgt, src, flavor="control", p=2, block=256, chunk=chunk)
    torch.cuda.synchronize()
    assert seen == [(name, ptf.stage(chunk)) for chunk in (512, 2048, 1032)
                    for name in ("nbody_ptile_forces", "nbody_flavor_forces")]


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("n,block,chunk,slabs", [
    (4096, 256, 128, None), (4096, 256, 512, 1), (4096, 512, 2048, None),
    (4096, 128, 256, 7), (4000, 192, 100, None), (4001, 1024, 1000, 3),
    (4000, 32, 260, 5), (4001, 64, 12, None)])
def test_stationary_acc_matches_plain(cuda, n, block, chunk, slabs, precise):
    """K5d against its plain version (the same runs of 256 a chunk), twice
    bit-equal, one launch a call: tiles of two targets a thread from 64
    on, one at 32; T = 4000 and 4001 end in a ragged tile (not a multiple
    of the tile), and chunks of 100, 1000, 260 and 12 end in a ragged batch
    of 8 (a chunk not a multiple of 8)."""
    sc = _scene(cuda, n)
    tgt = sc.tgt3()
    src = sc.src3(-(-sc.mass_len // chunk) * chunk)
    before = stf.LAUNCHES
    got, same = _twice(lambda: stf.stationary_acc(
        tgt, src, block=block, chunk=chunk, slabs=slabs, precise=precise))
    assert stf.LAUNCHES == before + 2 and same
    want = stf.stationary_acc_plain(tgt, src, chunk=chunk, precise=precise)
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


def test_stationary_acc_launch_error_raises(cuda, monkeypatch):
    """A failed K5d launch on CUDA tensors raises and counts nothing; the
    wrapper never takes its plain version there."""
    sc = _scene(cuda, 4096)

    class Failing:
        def nbody_stationary_forces(self, *args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(stf, "_lib", Failing)
    before = stf.LAUNCHES
    with pytest.raises(RuntimeError, match="stationary_forces"):
        stf.stationary_acc(sc.tgt3(), sc.src3(2048), chunk=512)
    assert stf.LAUNCHES == before


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


def test_newton_acc_launch_error_raises(cuda, monkeypatch):
    """A failed K5h launch on CUDA tensors raises and counts nothing; the
    wrapper never takes its plain version there."""
    sc = _scene(cuda, 4096)

    class Failing:
        def nbody_newton_forces(self, *args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(nwf, "_lib", Failing)
    before = nwf.LAUNCHES
    with pytest.raises(RuntimeError, match="newton_forces"):
        nwf.newton_acc(sc.tgt4(), sc.src4(sc.s128), sc.mass_len)
    assert nwf.LAUNCHES == before


# --- K5b: its own kernel ---

@pytest.mark.parametrize("flavor", ["base", "unroll2", "static", "partial"])
@pytest.mark.parametrize("p", v2.PS)
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("extra", [37, None])
def test_k5b_v2_acc_matches_plain(cuda, flavor, p, rows, extra):
    """Every flavor at P = 1 and 2 in both layouts against its plain
    version on the N=4096 scene, chunks of 1024: 2049 source rows (a last
    chunk of one source, 4-byte copies) or S128 = 2048 (16-byte copies),
    twice bit-equal, one launch a call. Bound TOL: the plain version
    follows the kernel's association but sums each chunk in its own
    order."""
    sc = _scene(cuda, 4096)
    tgt = sc.tgt3() if rows else (sc.pos, sc.radius)
    src = sc.src3(sc.s128 if extra is None else sc.mass_len + extra)
    before = v2.LAUNCHES
    got, same = _twice(lambda: v2.v2_acc(tgt, src, flavor=flavor, p=p,
                                         block=256, chunk=1024))
    assert v2.LAUNCHES == before + 2 and same
    want = v2.v2_acc_plain(tgt, src, flavor=flavor, chunk=1024)
    want = torch.cat(want) if rows else want
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


# SASS a pair of K5b's pair loops (row kernels) per flavor and P, as they
# were measured before K5a's kernels joined csrc/v2_forces.cu and the pair
# step moved into csrc/pair_step.cuh (CUDA 12.8 on the card, PERF.md §6):
# neither change may alter them.
K5B_SASS_A_PAIR = {("base", 1): 12.38, ("base", 2): 11.69,
                   ("unroll2", 1): 12.06, ("unroll2", 2): 11.53,
                   ("static", 1): 11.91, ("static", 2): 11.45,
                   ("partial", 1): 12.38, ("partial", 2): 11.69}


def test_k5b_pair_loops_keep_their_sass(cuda):
    """K5b's sixteen kernels, K5a's four (P = 1, 2; rsqrt, precise) and
    K5c's fourteen (unroll16 and six probes on rows at P = 1, 2) are all
    that ``v2_forces.cu`` builds, and K5b's pair loops keep their SASS a
    pair."""
    from nbody_tpu_torch.ablations import tune_r2b
    from nbody_tpu_torch.ops import _build, sass

    lib = _build.build_all(["v2_forces"])["v2_forces"][0]
    funcs = sass.functions(lib)
    names = [n for n in funcs if "v2_kernel" in n or "v2_resident_kernel" in n
             or "v2_probe_kernel" in n]
    assert len(names) == 34
    assert sum("v2_resident_kernel" in n and "PairTargets" in n
               for n in names) == 4
    assert sum("v2_probe_kernel" in n and "RowTargets" in n
               for n in names) == 12
    loops = tune_r2b.pair_loops(funcs, sass.ptxas_usage(
        lib.with_suffix(".log").read_text()), log=lambda *a: None)
    assert {k: round(v[0], 2) for k, v in loops.items()} == K5B_SASS_A_PAIR


def test_k5b_v2_acc_launch_error_raises(cuda, monkeypatch):
    """A failed launch on CUDA tensors raises; the wrapper never takes its
    plain version there."""
    sc = _scene(cuda, 4096)

    class Failing:
        def nbody_v2_forces(self, *args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(v2, "_lib", Failing)
    before = v2.LAUNCHES
    with pytest.raises(RuntimeError, match="v2_forces"):
        v2.v2_acc(sc.tgt3(), sc.src3(sc.s128))
    assert v2.LAUNCHES == before


# --- K5e, K5c, K5f, K5i: the flavored chunk kernel and the probes ---

def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("flavor,p", [
    *((f, 1) for f in ff.FLAVORS if f != "control"),
    *((f, p) for f in ("partial_jnp", "fma_kloop", "f_assoc") for p in (4, 8)),
])
def test_flavor_acc_matches_plain(cuda, flavor, p):
    """Every variant against its plain version on the N=4096 scene with
    2049 source rows in chunks of 1024 (a last chunk of one source), twice
    bit-equal. Bound TOL: the plain version follows the kernel's
    association but sums each run in its own order."""
    sc = _scene(cuda, 4096)
    tgt = sc.tgt3()
    src = sc.src3(sc.mass_len + 37)
    before = ff.LAUNCHES
    got, same = _twice(lambda: ff.flavor_acc(tgt, src, flavor=flavor, p=p,
                                             block=256, chunk=1024))
    assert ff.LAUNCHES == before + 2 and same
    want = torch.cat(ff.flavor_acc_plain(tgt, src, flavor=flavor, p=p,
                                         chunk=1024))
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("flavor", list(ff.FLAVORS))
def test_flavor_acc_p8_ragged_stages_match_plain(cuda, flavor):
    """Every K5e flavor at P = 8 (blocks of 64: 512 targets) on T = 4000
    (not a whole number of blocks) against 2013 source rows in chunks of
    1032 (the first chunk a stage of 1024 and one of 8, the second one
    stage of 981 with a ragged last batch; 4-byte copies): against its
    plain version (TOL), twice bit-equal, one launch a call."""
    sc = _scene(cuda, 4000)
    tgt = sc.tgt3()
    src = sc.src3(sc.mass_len + 37)
    before = ff.LAUNCHES
    got, same = _twice(lambda: ff.flavor_acc(tgt, src, flavor=flavor, p=8,
                                             block=64, chunk=1032))
    assert ff.LAUNCHES == before + 2 and same
    want = torch.cat(ff.flavor_acc_plain(tgt, src, flavor=flavor, p=8,
                                         chunk=1032))
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("flavor", list(v2.K5C))
@pytest.mark.parametrize("p", v2.PS)
def test_k5c_v2_acc_matches_plain(cuda, flavor, p):
    """K5c's probes, row variants of K5b's kernel, at P = 1 and 2 against
    their plain versions on the N=4096 scene with 2049 source rows in
    chunks of 1024 (a last chunk of one source, 4-byte copies), twice
    bit-equal, one K5b-kernel launch a call and none of K5e's; P = 1 and 2
    bit-equal to each other. Bound TOL: the plain version follows the
    kernel's association but sums each chunk in its own order."""
    sc = _scene(cuda, 4096)
    tgt = sc.tgt3()
    src = sc.src3(sc.mass_len + 37)
    before = (v2.LAUNCHES, ff.LAUNCHES)
    got, same = _twice(lambda: v2.v2_acc(tgt, src, flavor=flavor, p=p,
                                         block=512 // p, chunk=1024))
    assert (v2.LAUNCHES, ff.LAUNCHES) == (before[0] + 2, before[1]) and same
    want = torch.cat(v2.v2_acc_plain(tgt, src, flavor=flavor, chunk=1024))
    assert torch.isfinite(got).all()
    assert rel_err(got.cpu(), want.cpu()) < TOL
    other = torch.cat(v2.v2_acc(tgt, src, flavor=flavor, p=3 - p,
                                block=512 // (3 - p), chunk=1024))
    assert _bits_equal(got, other)


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


@pytest.mark.parametrize("t", [300, 1100])
@pytest.mark.parametrize("n_split", [None, 1, 3])
@pytest.mark.parametrize("variant", bp.VARIANTS)
def test_bcast_acc_matches_plain(cuda, variant, n_split, t):
    """Each broadcast on 300 targets (one block of 256 threads, two
    targets a thread: the second target of threads 44-255 lies past T) or
    1100 (three blocks, the last ragged) and 1024 sources, 5 sweeps, with
    the script's NaN-making third row: NaN where the plain version has
    NaN, the finite entries within 5e-6, twice bit-equal."""
    rng = np.random.RandomState(0)
    tgt = torch.from_numpy(rng.randn(3, t).astype(np.float32)).to(cuda)
    src = torch.from_numpy(rng.randn(3, 1024).astype(np.float32)).to(cuda)
    splits = n_split or bp.split_plan(t, 5, df.sm_count(cuda.index or 0))
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


def _contact_case(kind, device):
    if kind in contact_scenes.KINDS:
        return contact_scenes.contact_scene(kind, device)
    return _contact_scene(kind, device)


@pytest.mark.parametrize("kind", ["cluster", "ties", "chain", "boundary",
                                  *contact_scenes.KINDS])
@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_contacts_kernel_is_bit_equal_to_plain(cuda, kind, factor):
    pos, radius, mass, live = _contact_case(kind, cuda)
    col.LAUNCHES = 0
    got = col.contacts(pos, radius, mass, live, factor)
    again = col.contacts(pos, radius, mass, live, factor)
    want = col.contacts_plain(pos, radius, mass, live, factor)
    torch.cuda.synchronize()
    assert col.LAUNCHES == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1], again[1])
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("kind", ["cluster", "chain", *contact_scenes.KINDS])
def test_contacts_kernel_grid_is_contact_grid_bit_for_bit(cuda, kind):
    """The kernel's set-up (a radix select of the K-th largest radius, the
    scalars, the keys) forms collisions.contact_grid's grid exactly."""
    pos, radius, _, live = _contact_case(kind, cuda)
    for factor in (1.0, 1.5):
        got = col.contact_grid_kernel(pos, radius, live, factor)
        want = col.contact_grid(pos, radius, live, factor)
        torch.cuda.synchronize()
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("big_rows", [1, 5, 64])
def test_contacts_kernel_any_big_rows_is_the_same(cuda, monkeypatch,
                                                  big_rows):
    """Any number of big rows (each against every row; the rest on a grid
    as wide as their largest reach) gives the same answer."""
    for kind in ("cluster", "far_and_big"):
        pos, radius, mass, live = _contact_case(kind, cuda)
        want = col.contacts(pos, radius, mass, live, 1.0)
        monkeypatch.setattr(col, "BIG_ROWS", big_rows)
        got = col.contacts(pos, radius, mass, live, 1.0)
        monkeypatch.undo()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_contacts_kernel_refuses_too_many_big_rows(cuda, monkeypatch):
    pos, radius, mass, live = _contact_scene("cluster", cuda)
    monkeypatch.setattr(col, "BIG_ROWS", col.MAX_BIG + 1)
    with pytest.raises(ValueError, match="big rows"):
        col.contacts(pos, radius, mass, live, 1.0)


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


# --- the VJP kernels and the differentiable rollouts ---
# Bound 2e-5 of max|ref| for each cotangent: the kernels and the plain VJPs
# run the same fp32 formulas, summed in another order (the plain version
# sums a whole row of pairs at once) and with FMA contraction; a cotangent
# is a sum of terms of both signs, so its error is relative to the largest
# term, as a force's is.

VJP_TOL = 2e-5


def _vjp_case(device, t, s, seed=0, prefix=False):
    """force_acc_vjp inputs: t targets, half of them of radius 0, and s
    sources apart from them, a third with gm = 0; with ``prefix`` the
    sources are the first s targets (as a rollout passes p[:m]), radii
    positive. Where a target is its own source, the pair adds f·g to its
    target and source cotangents, which then dominate max|ref|: the
    sources apart are the stricter test of the other pairs."""
    pos, _, radius, gm = _inputs(device, t + s, s, seed=seed,
                                 zero_radius_tracers=False)
    gm[::3] = 0.0
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(t, 2)).astype(np.float32)).to(device)
    if prefix:
        return pos[:t].contiguous(), radius[:t].contiguous(), pos[:s], gm, g
    radius[:t:2] = 0.0
    return (pos[:t].contiguous(), radius[:t].contiguous(),
            pos[t:t + s].contiguous(), gm, g)


def _rel_each(got, want):
    return [0.0 if not w.abs().sum() else rel_err(a.cpu(), w.cpu())
            for a, w in zip(got, want)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("t,s,prefix", [(1000, 333, False), (1000, 0, False),
                                        (257, 1, False), (64, 20000, False),
                                        (300, 2000, False), (1000, 333, True)])
def test_force_acc_vjp_matches_plain_and_repeats(cuda, precise, t, s, prefix):
    args = _vjp_case(cuda, t, s, seed=t + s, prefix=prefix)
    before = df.VJP_LAUNCHES
    got = df.force_acc_vjp(*args, precise=precise)
    again = df.force_acc_vjp(*args, precise=precise)
    assert df.VJP_LAUNCHES == before + (2 if s else 0)
    want = df.force_acc_vjp_plain(*args, precise=precise)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.isfinite(a).all() for a in got)
    assert max(_rel_each(got, want)) < VJP_TOL


@pytest.mark.parametrize("t,s,own,split", [(200, 250, "sources", False),
                                           (700, 900, "sources", True),
                                           (1000, 333, "targets", True),
                                           (70000, 900, "targets", True),
                                           (900, 70000, "sources", True),
                                           (300000, 600, "targets", False),
                                           (64, 20000, "sources", False),
                                           (40000, 20000, "targets", True)])
def test_force_acc_vjp_any_plan_matches_plain(cuda, t, s, own, split):
    """Plans of one tile or many, with the other side split or not, and
    either side in registers (the larger one)."""
    plan = df.vjp_plan(t, s, df.device_sms(cuda))
    assert (plan.own, plan.n_split > 1) == (own, split), plan
    args = _vjp_case(cuda, t, s, seed=2)
    got = df.force_acc_vjp(*args)
    again = df.force_acc_vjp(*args)
    want = df.force_acc_vjp_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert max(_rel_each(got, want)) < VJP_TOL


def test_force_acc_backward_is_the_vjp_kernel(cuda):
    tp, tr, sp, sg, g = _vjp_case(cuda, 500, 200, seed=4)
    ts = [x.clone().requires_grad_() for x in (tp, tr, sp, sg)]
    before = df.VJP_LAUNCHES
    df.force_acc(*ts).backward(g)
    assert df.VJP_LAUNCHES == before + 1
    want = df.force_acc_vjp(tp, tr, sp, sg, g)
    assert all(torch.equal(x.grad, w) for x, w in zip(ts, want))


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("scene", ["random", "galaxies"])
def test_pp_cells_vjp_matches_plain_and_repeats(cuda, scene, precise):
    cells, rc, _ = _cells_scene(scene, cuda, 32)
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(cells[0].shape[0], 2)).astype(np.float32)).to(cuda)
    kw = dict(cap_t=32, cap_s=32, precise=precise)
    before = p3m_pp.VJP_LAUNCHES
    got = p3m_pp.pp_cells_vjp(*cells, rc, 4.0, g, **kw)
    again = p3m_pp.pp_cells_vjp(*cells, rc, 4.0, g, **kw)
    assert p3m_pp.VJP_LAUNCHES == before + 2   # one pass a call
    want = p3m_pp.pp_cells_vjp_plain(*cells, rc, 4.0, g, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.isfinite(a).all() for a in got)
    assert max(_rel_each(got, want)) < VJP_TOL
    # rows past a cell's cap, on both sides, get exactly 0
    for rows, out, start, counts in ((cells[0], got[0], cells[2], cells[3]),
                                     (cells[1], got[1], cells[4], cells[5])):
        idx, live = p3m_pp.run_slots(start, counts, 32, rows.shape[0])
        dropped = torch.ones(rows.shape[0], dtype=torch.bool, device=cuda)
        dropped[idx[live]] = False
        assert not out[dropped].abs().sum()


def _cells_of(device, counts_t, counts_s, seed, cell=4.0, own_sources=False):
    """Cell-sorted rows of a gc×gc grid of cells of size ``cell`` with the
    given counts (radius and gm drawn from the seed, as _random_cells
    draws them), the runs, and a cotangent. With ``own_sources`` the
    sources are the targets (counts_s = counts_t): every target meets
    itself at d² = 0; half the targets have radius 0 and sit on gm = 0
    sources (zero-radius tracers)."""
    rng = np.random.default_rng(seed)
    gc = int(round(len(counts_t) ** 0.5))
    rows = []
    for c, lo, hi in ((counts_t, 0.5, 9.5), (counts_s, 10.0, 1e4)):
        ids = np.repeat(np.arange(gc * gc), c)
        xy = (np.stack([ids // gc, ids % gc], 1)
              + rng.uniform(size=(len(ids), 2))) * cell
        w = rng.uniform(lo, hi, len(ids))
        rows.append(np.concatenate([xy, w[:, None], np.zeros((len(ids), 1))],
                                   1).astype(np.float32))
    if own_sources:
        rows[1][:, :2] = rows[0][:, :2]
        tracer = rng.uniform(size=len(rows[0])) < 0.5
        rows[0][tracer, 2] = 0.0
        rows[1][tracer, 2] = 0.0
    rows[0][:, 2] += np.float32(p3m_pp.SOFTENING_FLOOR)
    t = [torch.from_numpy(a).to(device) for a in (*rows, counts_t, counts_s)]
    starts = [torch.cumsum(c, 0, dtype=torch.int32) - c for c in t[2:]]
    g = torch.from_numpy(rng.normal(size=(len(rows[0]), 2))
                         .astype(np.float32)).to(device)
    return [t[0], t[1], starts[0], t[2], starts[1], t[3]], g


def _check_pp_vjp(cells, g, rc, cap_t, cap_s):
    """pp_cells_vjp twice bit-equal, finite, within VJP_TOL of the plain
    version, one launch a call, rsqrt and precise."""
    for precise in (False, True):
        kw = dict(cap_t=cap_t, cap_s=cap_s, precise=precise)
        before = p3m_pp.VJP_LAUNCHES
        got = p3m_pp.pp_cells_vjp(*cells, rc, 4.0, g, **kw)
        again = p3m_pp.pp_cells_vjp(*cells, rc, 4.0, g, **kw)
        assert p3m_pp.VJP_LAUNCHES == before + 2
        want = p3m_pp.pp_cells_vjp_plain(*cells, rc, 4.0, g, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(torch.isfinite(a).all() for a in got)
        assert max(_rel_each(got, want)) < VJP_TOL


def test_pp_cells_vjp_dense_cell_takes_ranges(cuda):
    """A cell of 700 targets among sources enough that its neighbourhood
    is cut into several ranges and its tasks come first (a galaxy core's
    shape at the N=1M slice: many tiles, thousands of sources)."""
    gc, cap = 6, 768
    rng = np.random.default_rng(5)
    counts_t = rng.integers(0, 40, gc * gc).astype(np.int32)
    counts_s = rng.integers(0, 40, gc * gc).astype(np.int32)
    counts_t[14], counts_s[14] = 700, 300
    counts_s[[7, 8, 9, 13, 15, 19, 20, 21]] = 250
    cells, g = _cells_of(cuda, counts_t, counts_s, seed=5)
    plan = p3m_pp.vjp_plan(cells[3], cells[5], gc, cap, cap)
    assert int(plan.ranges[14]) == -(-2300 // p3m_pp.VJP_RANGE) > 1
    assert int(plan.ends[gc * gc - 1]) == int(plan.ranges[14])   # heavy
    _check_pp_vjp(cells, g, 4.0, cap, cap)


def test_pp_cells_vjp_self_pairs_and_zero_radius_tracers(cuda):
    """Every target is its own source at d² = 0 (s = 0 there, so the pair
    adds w·g alone), and half of them are zero-radius tracers on gm = 0
    sources (r2 = 1e-18: the pair adds exactly 0, not 0 · inf)."""
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 48, 64).astype(np.int32)
    counts[:3] = (0, 32, 40)
    cells, g = _cells_of(cuda, counts, counts, seed=6, own_sources=True)
    _check_pp_vjp(cells, g, 4.0, 32, 32)


def _rollout_scene(n, seed=11037):
    w = nt.create_world(nt.make_galaxies(n, 2, seed=seed), device="cpu")
    return [getattr(w.state, k) for k in ("pos", "vel", "mass", "radius")], \
        w.mass_len


@pytest.mark.parametrize("integrator", ["euler", "yoshida4"])
def test_cuda_rollout_grads_match_torch_rollout(cuda, integrator):
    """The "cuda" rollout (K1 forward, the VJP kernels backward) against the
    "torch" one on the card: value, and the gradients with respect to
    pos0, vel0, mass, radius and dt within 1e-4 of max|ref| (JAX's bound
    between "pallas" and "jnp"); one VJP call a force evaluation."""
    from nbody_tpu_torch import autodiff

    (pos, vel, mass, radius), ml = _rollout_scene(1200)
    stages = 3 if integrator == "yoshida4" else 1
    loss = autodiff.trajectory_loss(torch.zeros(2, device=cuda), index=ml + 5)

    def run(backend):
        xs = [x.to(cuda).requires_grad_() for x in (pos, vel, mass, radius)]
        dt = torch.tensor(0.01, device=cuda, requires_grad=True)
        val = loss(*xs, dt, n_steps=3, mass_len=ml, backend=backend,
                   integrator=integrator)
        return val, torch.autograd.grad(val, [*xs, dt])

    before = df.VJP_LAUNCHES
    v_c, g_c = run("cuda")
    assert df.VJP_LAUNCHES == before + 3 * stages
    v_t, g_t = run("torch")
    assert float(v_c) == pytest.approx(float(v_t), rel=1e-5)
    for a, b in zip(g_c, g_t):
        assert torch.isfinite(a).all()
        assert rel_err(a.cpu().reshape(-1), b.cpu().reshape(-1)) < 1e-4


def test_p3m_rollout_on_the_card_matches_the_cpu_and_repeats(cuda):
    """The "p3m" rollout on the card (K4 and its VJP kernels, force_acc and
    its VJP kernels for the exact-core rows): two steps twice bit-equal,
    with one VJP call of each a step; one step against the same rollout on
    the CPU (plain versions), value and gradient. One step only: after it
    the two devices' positions differ in the last bits (cuFFT and the CPU's
    FFT round differently), which can move a particle across a CIC cell
    boundary, where the mesh force's gradient jumps."""
    from nbody_tpu_torch import autodiff

    (pos, vel, mass, radius), ml = _rollout_scene(3000)
    kw = dict(mass_len=ml, backend="p3m", pm_grid=128, p3m_cell_capacity=32,
              p3m_exact_targets=16, precise=False)

    def run(device, n_steps):
        p = pos.to(device).requires_grad_()
        out, _ = autodiff.rollout(p, vel.to(device), mass.to(device),
                                  radius.to(device), 0.01, n_steps=n_steps,
                                  **kw)
        val = torch.sum(out ** 2) * 1e-6
        return val, torch.autograd.grad(val, p)[0]

    before = (p3m_pp.VJP_LAUNCHES, df.VJP_LAUNCHES)
    v1, g1 = run(cuda, 2)
    assert (p3m_pp.VJP_LAUNCHES, df.VJP_LAUNCHES) == (before[0] + 2,
                                                      before[1] + 2)
    v2, g2 = run(cuda, 2)
    assert torch.equal(g1, g2) and torch.equal(v1, v2)
    assert torch.isfinite(g1).all()
    v_card, g_card = run(cuda, 1)
    v_cpu, g_cpu = run("cpu", 1)
    assert float(v_card) == pytest.approx(float(v_cpu), rel=1e-5)
    assert rel_err(g_card.cpu(), g_cpu) < 1e-4


def test_sharded_cuda_rollout_matches_single_device(cuda):
    """rollout_sharded "cuda" with four shards on one card against the
    single-device "cuda" rollout, within nbody_tpu's bounds (value 1e-5
    relative, gradient 3e-5): a loss of one tracer over three steps; the
    same loss over one step without the tracer's own row, where each other
    row is one pair's term reached through the ring's backward alone; and
    nbody_tpu's own case, sum(pos²) on one galaxy of 500. (On two galaxies
    the gradient of sum(pos²) is a small remainder of terms that cancel at
    the cores, which two summation orders resolve differently:
    tests/test_torch_autodiff.py::test_sharded_gradient_conditioning.)"""
    from nbody_tpu_torch import autodiff

    def run(state, ml, loss, sharded, n_steps=3):
        pos, vel, mass, radius = state
        p = pos.to(cuda).requires_grad_()
        args = [x.to(cuda) for x in (vel, mass, radius)]
        kw = dict(n_steps=n_steps, mass_len=ml, backend="cuda")
        if sharded:
            out, _ = autodiff.rollout_sharded(p, *args, 0.01,
                                              mesh=[cuda] * 4, **kw)
        else:
            out, _ = autodiff.rollout(p, *args, 0.01, **kw)
        val = loss(out)
        return float(val), torch.autograd.grad(val, p)[0].cpu()

    state, ml = _rollout_scene(2000)
    target = state[0][ml].to(cuda) + 5.0

    def tracer(out):
        return torch.sum((out[ml] - target) ** 2)

    v_s, g_s = run(state, ml, tracer, True)
    v_1, g_1 = run(state, ml, tracer, False)
    assert v_s == pytest.approx(v_1, rel=1e-5)
    assert rel_err(g_s, g_1) < 3e-5
    _, g_s = run(state, ml, tracer, True, n_steps=1)
    _, g_1 = run(state, ml, tracer, False, n_steps=1)
    off = torch.arange(g_1.shape[0]) != ml
    assert g_1[off].abs().max() > 0
    assert rel_err(g_s[off], g_1[off]) < 3e-5
    w = nt.create_world(nt.make_galaxies(500, 1, seed=4), device="cpu")
    one = [getattr(w.state, k) for k in ("pos", "vel", "mass", "radius")]

    def squares(out):
        return torch.sum(out ** 2)

    v_s, g_s = run(one, w.mass_len, squares, True)
    v_1, g_1 = run(one, w.mass_len, squares, False)
    assert v_s == pytest.approx(v_1, rel=1e-5)
    assert rel_err(g_s, g_1) < 3e-5


# --- the sharded mesh solvers, D shards on one card ---

def _mesh_shards(cuda, backend, d, scene, cfg):
    return ShardedWorld(scene, make_mesh(devices=[cuda] * d), config=cfg,
                        force_backend=backend)


def test_sharded_p3m_on_one_card_repeats_with_exact_launches(cuda):
    """D=4 "p3m" shards on one card: two runs from the same state give the
    same bits (the grids and the exact-core partials are summed in shard
    order), each evaluation launches K4 once a shard and force_acc once a
    shard that holds sources, and the substeps make no host sync."""
    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=32)
    scene = nt.make_galaxies(20_000, 2, seed=11037)
    runs = []
    for _ in range(2):
        sw = _mesh_shards(cuda, "p3m", 4, scene, cfg)
        with_src = sum(r > 0 for r in sw._src_rows)
        df.LAUNCHES = p3m_pp.LAUNCHES = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sw.update(0.01, 3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert (p3m_pp.LAUNCHES, df.LAUNCHES) == (3 * 4, 3 * with_src)
        runs.append(sw.particles)
    assert 1 < with_src < 4
    for name in ("pos", "vel", "acc"):
        got = getattr(runs[0], name)
        assert torch.isfinite(got).all(), name
        assert torch.equal(got, getattr(runs[1], name)), name


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_sharded_mesh_one_shard_is_the_world_on_the_card(cuda, backend):
    """D=1 on the card: a sum over one shard adds nothing and the padding
    rows are no sources, so every field is the World's bit for bit."""
    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=32)
    scene = nt.make_galaxies(20_000, 2, seed=5)
    sw = _mesh_shards(cuda, backend, 1, scene, cfg)
    w = nt.create_world(scene, config=cfg, device=cuda)
    sw.update(0.01, 3)
    w.update(0.01, 3, backend=backend)
    for name in ("pos", "vel", "acc"):
        assert torch.equal(getattr(sw.particles, name),
                           getattr(w.particles, name)), name


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_sharded_mesh_on_the_card_matches_the_cpu(cuda, backend):
    """D=4 on one card against D=4 CPU shards (the plain versions), 3
    substeps, with test_world_p3m_on_the_card's bounds (cuFFT against the
    CPU's FFT: fp32 noise)."""
    cfg = nt.SimConfig(pm_grid=256, p3m_cell_capacity=32)
    scene = nt.make_galaxies(4000, 2, seed=11037)
    sw_k = _mesh_shards(cuda, backend, 4, scene, cfg)
    sw_p = ShardedWorld(scene, make_mesh(devices=["cpu"] * 4), config=cfg,
                        force_backend=backend)
    sw_k.update(0.01, 3)
    sw_p.update(0.01, 3)
    for name, tol in (("pos", 1e-6), ("vel", 2e-5), ("acc", 2e-5)):
        got, want = getattr(sw_k.particles, name), getattr(sw_p.particles, name)
        assert torch.isfinite(got).all()
        assert rel_err(got, want) < tol, name


def test_pp_cells_cut_counts_leave_rows_zero_on_the_card(cuda):
    """The drop rule's cut: counts below the runs' lengths leave the rest
    of each run at exactly 0, and the kept rows get the bits they get with
    the whole runs (each target's sum is its own), within 1e-5 of the
    plain version on the same cut."""
    cells, rc, _ = _galaxy_cells(cuda)
    trows, srows, start_t, counts_t, start_s, counts_s = cells
    cut = torch.clamp(counts_t - 5, min=0).to(torch.int32)
    whole = p3m_pp.pp_cells(*cells, rc, 4.0, cap_t=32, cap_s=32)
    got = p3m_pp.pp_cells(trows, srows, start_t, cut, start_s, counts_s, rc,
                          4.0, cap_t=32, cap_s=32)
    idx, live = p3m_pp.run_slots(start_t, cut, 32, len(trows))
    kept = torch.zeros(len(trows), dtype=torch.bool, device=cuda)
    kept[idx[live]] = True
    assert (whole[~kept] != 0).any()
    assert torch.equal(got[~kept], torch.zeros_like(got[~kept]))
    assert torch.equal(got[kept], whole[kept])
    want = p3m_pp.pp_cells_plain(trows.cpu(), srows.cpu(), start_t.cpu(),
                                 cut.cpu(), start_s.cpu(), counts_s.cpu(), rc,
                                 4.0, cap_t=32, cap_s=32)
    assert rel_err(got.cpu(), want) < TOL


def test_sharded_p3m_rollout_on_the_card_matches_the_cpu(cuda):
    """rollout_sharded "p3m" with four shards on one card (K4 and its VJP
    kernel on each shard, the cut counts in both): two steps twice
    bit-equal with one K4 VJP call a shard a step; one step against four
    CPU shards (the plain versions), value 1e-5 relative and gradient 1e-4
    of max, test_p3m_rollout_on_the_card_matches_the_cpu_and_repeats'
    bounds (one step, for the reason given there)."""
    from nbody_tpu_torch import autodiff

    (pos, vel, mass, radius), ml = _rollout_scene(3000)
    kw = dict(mass_len=ml, backend="p3m", pm_grid=128, p3m_cell_capacity=32,
              p3m_exact_targets=16, precise=False)

    def run(device, n_steps):
        p = pos.to(device).requires_grad_()
        out, _ = autodiff.rollout_sharded(
            p, vel.to(device), mass.to(device), radius.to(device), 0.01,
            n_steps=n_steps, mesh=[device] * 4, **kw)
        val = torch.sum(out ** 2) * 1e-6
        return val, torch.autograd.grad(val, p)[0]

    before = p3m_pp.VJP_LAUNCHES
    v1, g1 = run(cuda, 2)
    assert p3m_pp.VJP_LAUNCHES == before + 2 * 4
    v2, g2 = run(cuda, 2)
    assert torch.equal(g1, g2) and torch.equal(v1, v2)
    assert torch.isfinite(g1).all()
    v_card, g_card = run(cuda, 1)
    v_cpu, g_cpu = run(torch.device("cpu"), 1)
    assert float(v_card) == pytest.approx(float(v_cpu), rel=1e-5)
    assert rel_err(g_card.cpu(), g_cpu) < 1e-4


# --- the device-side scenes, K1 with every row a source, the AVX oracle ---

def _scene_makers():
    from nbody_tpu_torch import models

    return {"galaxies": (models.make_galaxies_device, (65536, 3)),
            "plummer": (models.make_plummer_disk, (8192,)),
            "kepler": (models.make_kepler_disk, (8192,)),
            "cold": (models.make_cold_disk, (8192,))}


@pytest.mark.parametrize("name", ["galaxies", "plummer", "kepler", "cold"])
def test_scene_on_the_card_repeats_without_a_host_sync(cuda, name):
    """Each generator draws on the card by default: twice from one seed,
    bit-equal, with the sync debug mode raising on any host sync; every
    field fp32 and finite on the card."""
    make, args = _scene_makers()[name]
    runs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            runs.append(make(11037, *args))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a, b = runs
    for field in ("pos", "vel", "acc", "mass", "radius"):
        x = getattr(a, field)
        assert x.device.type == "cuda" and x.dtype == torch.float32
        assert torch.isfinite(x).all()
        assert torch.equal(x, getattr(b, field)), field
    gen = torch.Generator(device=cuda).manual_seed(11037)
    assert torch.equal(make(gen, *args).pos, a.pos)


def test_direct_kernel_on_an_all_massive_scene(cuda):
    """K1 with every row a source (S = N, the Plummer disk): force_acc and
    the fused substep against the plain version."""
    from nbody_tpu_torch.models import make_plummer_disk

    p = make_plummer_disk(3, 8192)
    w = nt.create_world(p, device=cuda)
    assert w.mass_len == 8192
    st = w.state
    for precise in (False, True):
        want = df.force_acc_plain(st.pos, st.radius, st.pos, w.gm, precise=precise)
        got = df.force_acc(st.pos, st.radius, st.pos, w.gm, precise=precise)
        assert rel_err(got.cpu(), want.cpu()) < TOL
        _, nvel, acc = df.fused_substep(0.01, st.pos, st.vel, st.radius, w.gm,
                                        precise=precise)
        assert rel_err(acc.cpu(), want.cpu()) < TOL
        assert rel_err(nvel.cpu(), (st.vel + 0.01 * acc).cpu()) < EPILOGUE_TOL


@pytest.mark.parametrize("scene", ["galaxies", "plummer"])
def test_avx_oracle_judges_the_card_world(cuda, scene):
    """One substep of 0.01 of the "cuda" World (precise: the oracle takes
    IEEE sqrt) against the native AVX oracle on the same massive-first
    state: acc, vel and pos within 5e-6 of max|ref|."""
    from nbody_tpu_torch.models import make_plummer_disk
    from nbody_tpu_torch.utils import cpp_oracle

    p = (nt.make_galaxies(8192, 2, seed=11037) if scene == "galaxies"
         else make_plummer_disk(3, 4096))
    w = nt.create_world(p, config=nt.SimConfig(precise=True), device=cuda)
    want = cpp_oracle.oracle_update(w.particles, w.mass_len, 0.01, 1)
    w.update(0.01, 1)
    got = w.particles
    for field in ("acc", "vel", "pos"):
        assert rel_err(getattr(got, field), getattr(want, field)) < 5e-6, field
