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
from nbody_tpu_torch.ops import direct_forces as df
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
    """Few targets: the launch splits the source sum (_split_plan > 1)."""
    assert df._split_plan(t, n_src, df.sm_count(cuda.index or 0)) > 1
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


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_world_p3m_on_the_card(cuda, integrator):
    """The p3m world on the card (K4 and the split force_acc) against the
    same scene's plain path on the CPU, 5 substeps. The card's CIC scatter
    sums by atomics in a varying order and its FFT is cuFFT, so the mesh
    force differs from the CPU's at fp32 noise. Bounds: pos 1e-6, vel and
    acc 2e-5 of max, the CPU-vs-JAX tolerances of test_torch_p3m.py."""
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
