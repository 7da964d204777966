"""The port's P³M path (nbody_tpu_torch/ops/p3m_forces.py, ops/p3m_pp.py,
World(backend="p3m")) against nbody_tpu's on the same numpy inputs, plus
the source-split plan of the direct kernel and the device default.

Cell structure (sort orders, ranks, counts, packed blocks, overflow) must
agree bit for bit. Forces carry the tolerances stated at each test."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

import nbody_tpu as nb
from nbody_tpu.ops import p3m_forces as jp3m
from nbody_tpu.ops import p3m_pallas
from nbody_tpu.ops import pm_forces as jpm
import nbody_tpu_torch as nt
from nbody_tpu_torch import forces
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import p3m_forces as tp3m
from nbody_tpu_torch.ops import p3m_pp
from nbody_tpu_torch.ops import pm_forces as tpm


def _scene(n, galaxies=2, seed=11037):
    """A JAX world's (pos, radius, src_pos, gm) as numpy, massive first."""
    w = nb.create_world(nb.make_galaxies(n, galaxies, seed=seed))
    pos = np.array(w.state.pos[:w.total_len])
    radius = np.array(w.state.radius[:w.total_len])
    gm = np.array(w.gm[:w.mass_len])
    return pos, radius, pos[:w.mass_len].copy(), gm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _cells(pos, src, gm, grid, rc_cells=4):
    """(JAX lo, h, inv_c), (port lo, h, inv_c) and gc on one scene."""
    gc = grid // rc_cells
    lo_j, h_j = jpm._box(*jpm._bounds(jnp.asarray(pos), jnp.asarray(src),
                                      jnp.asarray(gm), None), grid)
    lo_t, h_t = tpm._box(*tpm._bounds(*_t(pos, src, gm)), grid)
    return ((lo_j, h_j, 1.0 / ((grid * h_j) / gc)),
            (lo_t, h_t, 1.0 / ((grid * h_t) / gc)), gc)


def _equal_mass_scene():
    """Many equal masses in a few cells: pins the tie order of the
    heaviest-first source sort (stable, as jnp.lexsort)."""
    rng = np.random.default_rng(3)
    pos = (rng.normal(size=(600, 2)) * [40.0, 25.0]).astype(np.float32)
    gm = np.where(rng.uniform(size=600) < 0.5, 100.0, 250.0).astype(np.float32)
    return pos, gm


# --- cell structure, bit for bit ---

@pytest.mark.parametrize("scene", ["galaxies", "equal_masses"])
@pytest.mark.parametrize("priority", [True, False])
def test_cell_pack_bit_exact(scene, priority):
    if scene == "galaxies":
        pos, _, src, gm = _scene(2048)
        pts = src
    else:
        pts, gm = _equal_mass_scene()
        pos = src = pts
    (lo_j, _, ic_j), (lo_t, _, ic_t), gc = _cells(pos, src, gm, 128)
    want = jp3m._cell_pack(jnp.asarray(pts), lo_j, ic_j, gc,
                           priority=jnp.asarray(gm) if priority else None)
    got = tp3m._cell_pack(*_t(pts), lo_t, ic_t, gc,
                          priority=_t(gm)[0] if priority else None)
    for name, g, w in zip(("order", "cid", "rank", "counts"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_gather_blocks_bit_exact():
    """Random occupancy with overflow (cap 3 against up to ~8 per cell)."""
    rng = np.random.default_rng(0)
    gc, cap, n = 4, 3, 50
    cid = np.sort(rng.integers(0, gc * gc, n))
    counts = np.bincount(cid, minlength=gc * gc).astype(np.int32)
    vals = rng.normal(size=(3, n)).astype(np.float32)
    fills = (0.0, 7.0, 1.0)
    want = jp3m._gather_blocks([(jnp.asarray(v), f) for v, f in zip(vals, fills)],
                               jnp.asarray(counts), gc, cap)
    got = tp3m._gather_blocks([(torch.from_numpy(v), f) for v, f in zip(vals, fills)],
                              torch.from_numpy(counts), gc, cap)
    for g, w in zip(got, want):
        assert g.is_contiguous() and tuple(g.shape) == (gc, gc, cap)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap", [8, 32])
def test_pack_source_blocks_bit_exact(cap):
    pos, _, src, gm = _scene(2048)
    (lo_j, _, ic_j), (lo_t, _, ic_t), gc = _cells(pos, src, gm, 256)
    want = jp3m._pack_source_blocks(jnp.asarray(src), jnp.asarray(gm), lo_j,
                                    ic_j, gc, cap)
    tsrc, tgm = _t(src, gm)
    order_s, _, _, counts_s = tp3m._cell_pack(tsrc, lo_t, ic_t, gc, priority=tgm)
    got = tp3m._pack_source_blocks(tsrc, tgm, order_s, counts_s, gc, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["galaxies_cap8", "galaxies_cap96", "one_cell"])
def test_p3m_cell_overflow_matches(case):
    if case == "one_cell":
        # tests/test_p3m.py: 20 near-coincident sources, capacity 8 -> 12
        n = 20
        pos = np.stack([np.linspace(0.0, 1.0, n), np.zeros(n)], 1) * 1e-3
        src = np.concatenate([pos, [[100.0, 100.0]]]).astype(np.float32)
        gm = np.concatenate([np.arange(1.0, n + 1.0), [1.0]]).astype(np.float32)
        kw = dict(grid=64, rc_cells=16, cell_capacity=8)
    else:
        _, _, src, gm = _scene(4096, galaxies=1)
        kw = dict(grid=256, rc_cells=4,
                  cell_capacity=8 if case == "galaxies_cap8" else 96)
    want = int(jp3m.p3m_cell_overflow(jnp.asarray(src), jnp.asarray(gm), **kw))
    got = nt.p3m_cell_overflow(*_t(src, gm), **kw)
    assert int(got) == want
    if case == "one_cell":
        assert want == 12
    elif case == "galaxies_cap8":
        assert want > 0


# --- the pair correction on packed blocks ---

def _packed_blocks(cap=16, grid=128, n=600):
    """tests/test_p3m.py::test_pp_pallas_kernel_matches_jnp_path's blocks."""
    pos, rad, src, gm = _scene(n)
    (lo, h, ic), _, gc = _cells(pos, src, gm, grid)
    sx, sy, sg = jp3m._pack_source_blocks(jnp.asarray(src), jnp.asarray(gm),
                                          lo, ic, gc, cap)
    order_t, _, _, counts_t = jp3m._cell_pack(jnp.asarray(pos), lo, ic, gc)
    pt = jnp.asarray(pos)[order_t]
    tx, ty, tr = jp3m._gather_blocks(
        [(pt[:, 0], 0.0), (pt[:, 1], 0.0), (jnp.asarray(rad)[order_t], 1.0)],
        counts_t, gc, cap)
    blocks = [np.asarray(a) for a in (tx, ty, tr, sx, sy, sg)]
    return blocks, float(4 * h), np.asarray(counts_t)


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "jnp"])
def test_pp_blocks_plain_matches_nbody_tpu(precise, oracle):
    """All slots, no counts; bound 5e-5 of max|ref|, the one
    tests/test_p3m.py holds the Pallas kernel to against _pp_blocks_jnp.
    The correction jumps at d = rc (it is exact³ − smooth³ there, not 0),
    so a pair whose d² or u lands an ulp away on the other side changes
    the sum by a whole pair term: XLA contracts d² into an FMA on the CPU,
    and _pp_blocks_jnp divides by rc where the port multiplies by 1/rc.
    Measured up to 2.2e-5 here."""
    blocks, rc, _ = _packed_blocks()
    if oracle == "pallas_interpret":
        want = p3m_pallas.pp_blocks(*map(jnp.asarray, blocks), rc, 4.0,
                                    precise=precise, interpret=True)
    else:
        tx, ty, tr, sx, sy, sg = map(jnp.asarray, blocks)
        want = p3m_pallas._pp_blocks_jnp(tx, ty, tr + nb.types.SOFTENING_FLOOR,
                                         sx, sy, sg, rc, 4.0, precise=precise)
    got = p3m_pp.pp_blocks(*_t(*blocks), rc, 4.0, precise=precise)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert rel_err(got, want) < 5e-5


def test_pp_blocks_counts_semantics():
    """counts_t zeroes slots at or past each cell's count; counts_s reads
    only occupied source slots, which changes nothing (empty slots hold
    gm = 0): the live slots agree to 1e-6 of max|a| (the plain version
    computes other chunks of cells, so PyTorch may split its sums across
    threads differently)."""
    blocks, rc, counts_t = _packed_blocks()
    tb = _t(*blocks)
    gc, _, cap = blocks[0].shape
    full = p3m_pp.pp_blocks(*tb, rc, 4.0)
    counts_s = torch.from_numpy((np.asarray(blocks[5]) != 0).sum(-1)
                                .reshape(-1).astype(np.int32))
    ct = torch.from_numpy(counts_t.astype(np.int32))
    got = p3m_pp.pp_blocks(*tb, rc, 4.0, counts_t=ct, counts_s=counts_s)
    live = torch.arange(cap)[None, :] < ct.clamp(max=cap)[:, None]
    assert rel_err(got[live], full[live]) < 1e-6
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


def test_pp_blocks_refuses_bad_inputs():
    blocks = _t(*_packed_blocks()[0])
    with pytest.raises(ValueError):
        p3m_pp.pp_blocks(*blocks[:3], *(b[:, :-1] for b in blocks[3:]), 1.0, 4.0)
    with pytest.raises(TypeError):
        p3m_pp.pp_blocks(*(b.double() for b in blocks), 1.0, 4.0)
    with pytest.raises(ValueError):
        p3m_pp.pp_blocks(*blocks, 1.0, 4.0,
                         counts_t=torch.zeros(3, dtype=torch.int32))


# --- the pair correction on cell-sorted rows (the main path's layout) ---

def _packed_cells(cap=16, grid=128, n=600):
    """_packed_blocks' scene as nbody_tpu's blocks (numpy) and as the
    port's cell-sorted rows and runs, both from nbody_tpu's cell orders."""
    pos, rad, src, gm = _scene(n)
    (lo, h, ic), _, gc = _cells(pos, src, gm, grid)
    blocks, _, _ = _packed_blocks(cap, grid, n)
    order_t, _, _, counts_t = (np.asarray(a) for a in jp3m._cell_pack(
        jnp.asarray(pos), lo, ic, gc))
    order_s, _, _, counts_s = (np.asarray(a) for a in jp3m._cell_pack(
        jnp.asarray(src), lo, ic, gc, priority=jnp.asarray(gm)))
    zeros = np.zeros((n, 1), np.float32)
    trows = np.concatenate([pos, (rad + np.float32(nb.types.SOFTENING_FLOOR))
                            [:, None], zeros], 1)[order_t]
    srows = np.concatenate([src, gm[:, None], zeros[:len(gm)]], 1)[order_s]
    runs = [np.cumsum(c).astype(np.int32) - c for c in (counts_t, counts_s)]
    cells = _t(trows, srows, runs[0], counts_t.astype(np.int32), runs[1],
               counts_s.astype(np.int32))
    return blocks, cells, float(4 * h)


def _slots_to_rows(per_slot, start, counts, cap, n):
    """(n, 2) sorted rows from a (gc², cap, 2) per-slot result: each live
    slot's value at its row, 0 in the rows past a cell's cap."""
    idx, live = p3m_pp.run_slots(start, counts, cap, n)
    rows = torch.zeros((n, 2), dtype=torch.float32)
    rows[idx[live]] = torch.as_tensor(np.asarray(per_slot))[live]
    return rows


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "jnp"])
def test_pp_cells_plain_matches_nbody_tpu(precise, oracle):
    """The rows route against nbody_tpu's pp_blocks on the same cells, its
    per-slot result taken to sorted rows. Bound 5e-5 of max|ref|, for the
    reason test_pp_blocks_plain_matches_nbody_tpu gives (a pair on the rc
    boundary may flip between XLA's FMA and the port's product)."""
    blocks, cells, rc = _packed_cells()
    cap = blocks[0].shape[-1]
    if oracle == "pallas_interpret":
        want = p3m_pallas.pp_blocks(*map(jnp.asarray, blocks), rc, 4.0,
                                    precise=precise, interpret=True)
    else:
        tx, ty, tr, sx, sy, sg = map(jnp.asarray, blocks)
        want = p3m_pallas._pp_blocks_jnp(tx, ty, tr + nb.types.SOFTENING_FLOOR,
                                         sx, sy, sg, rc, 4.0, precise=precise)
    n = cells[0].shape[0]
    want = _slots_to_rows(want, cells[2], cells[3], cap, n)
    got = p3m_pp.pp_cells_plain(*cells, rc, 4.0, cap_t=cap, cap_s=cap,
                                precise=precise)
    assert tuple(got.shape) == (n, 2)
    assert rel_err(got, want) < 5e-5


def test_pp_cells_overflow_rows_are_zero():
    """Cap 8 on the galaxy scene: the targets past their cell's cap get
    exactly 0 (mesh only); the others match the blocks route bit for bit,
    which the plain version computes with the same expressions in the same
    order (the taper's ``sqrt(d² + 1e-12) · (1/rc)`` through the correctly
    rounded ``forces.sqrt``, the same in every process and call)."""
    pos, rad, src, gm = (torch.from_numpy(a) for a in _scene(2048))
    bins = tp3m.p3m_bins(pos, rad, src, gm, grid=256, rc_cells=4,
                         exact_targets=0)
    rc = 4 * bins["h"]
    trows = tp3m._cell_rows(pos, rad + nb.types.SOFTENING_FLOOR, bins["order_t"])
    srows = tp3m._cell_rows(src, gm, bins["order_s"])
    got = p3m_pp.pp_cells(trows, srows, bins["start_t"], bins["counts_t"],
                          bins["start_s"], bins["counts_s"], rc, 4.0,
                          cap_t=8, cap_s=8)
    rank = torch.arange(len(pos)) - bins["start_t"].long().repeat_interleave(
        bins["counts_t"].long())
    over = rank >= 8
    assert over.any() and (~over).any()
    assert torch.equal(got[over], torch.zeros_like(got[over]))
    assert (got[~over] != 0).any()
    gc = 64
    tb = tp3m._gather_blocks([(trows[:, 0], 0.0), (trows[:, 1], 0.0),
                              (rad[bins["order_t"]], 1.0)],
                             bins["counts_t"], gc, 8)
    sb = tp3m._pack_source_blocks(src, gm, bins["order_s"], bins["counts_s"],
                                  gc, 8)
    want = p3m_pp.pp_blocks(*tb, *sb, rc, 4.0, counts_t=bins["counts_t"],
                            counts_s=bins["counts_s"])
    rows = _slots_to_rows(want, bins["start_t"], bins["counts_t"], 8, len(pos))
    assert torch.equal(rows[over], got[over])
    assert torch.equal(got, rows)


@pytest.mark.parametrize("cap", [8, 32])
def test_bins_runs_address_the_block_slots(cap):
    """p3m_bins' starts and counts address, in the sorted rows, exactly
    the rows that the packed blocks hold, slot for slot, on both sides."""
    pos, rad, src, gm = (torch.from_numpy(a) for a in _scene(2048))
    bins = tp3m.p3m_bins(pos, rad, src, gm, grid=256, rc_cells=4,
                         exact_targets=0)
    gc = 64
    for side, pts, order, vals in (("t", pos, bins["order_t"], rad),
                                   ("s", src, bins["order_s"], gm)):
        start, counts = bins["start_" + side], bins["counts_" + side]
        assert start.dtype == torch.int32 and counts.dtype == torch.int32
        assert torch.equal(start[1:], torch.cumsum(counts, 0)[:-1].int())
        rows = tp3m._cell_rows(pts, vals, order)
        assert torch.equal(rows, torch.cat([pts, vals[:, None],
                                            torch.zeros_like(vals)[:, None]],
                                           1)[order])
        blocks = tp3m._gather_blocks([(rows[:, k], 0.0) for k in range(3)],
                                     counts, gc, cap)
        idx, live = p3m_pp.run_slots(start, counts, cap, len(pts))
        for k, b in enumerate(blocks):
            b = b.reshape(gc * gc, cap)
            assert torch.equal(b[live], rows[idx[live], k])
            assert torch.equal(b[~live], torch.zeros_like(b[~live]))


def test_pp_cells_refuses_bad_inputs():
    _, cells, rc = _packed_cells()
    trows, srows, st, ct, ss, cs = cells
    kw = dict(cap_t=16, cap_s=16)
    with pytest.raises(TypeError):                  # dtype
        p3m_pp.pp_cells(trows.double(), srows, st, ct, ss, cs, rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # shape
        p3m_pp.pp_cells(trows[:, :3].contiguous(), srows, st, ct, ss, cs,
                        rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # contiguity
        wide = torch.zeros((trows.shape[0], 8))
        p3m_pp.pp_cells(wide[:, :4], srows, st, ct, ss, cs, rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # device
        p3m_pp.pp_cells(trows, srows, st, ct, ss, cs.to("meta"), rc, 4.0,
                        **kw)
    with pytest.raises(ValueError):                 # count length
        p3m_pp.pp_cells(trows, srows, st, ct, ss, cs[:-1], rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # not gc² cells
        p3m_pp.pp_cells(trows, srows, st[:-1], ct[:-1], ss[:-1], cs[:-1],
                        rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # count dtype
        p3m_pp.pp_cells(trows, srows, st, ct.long(), ss, cs, rc, 4.0, **kw)
    with pytest.raises(ValueError):                 # capacity
        p3m_pp.pp_cells(trows, srows, st, ct, ss, cs, rc, 4.0, cap_t=0,
                        cap_s=16)


# --- p3m_acc and the World ---

@pytest.mark.parametrize("cap", [32, 96])
def test_p3m_acc_matches_nbody_tpu(cap):
    """grid 256. Both sides: the same cells, the same pair set; they differ
    in the mesh stage's FFT sums and in u = d·(1/rc) against d/rc (see
    above). Measured 6.8e-7 of max|a|; bound 1e-5."""
    pos, rad, src, gm = _scene(2048)
    want = jp3m.p3m_acc(*map(jnp.asarray, (pos, rad, src, gm)), 2.0, grid=256,
                        cell_capacity=cap)
    got = nt.p3m_acc(*_t(pos, rad, src, gm), 2.0, grid=256, cell_capacity=cap)
    assert rel_err(got, want) < 1e-5


def _scene_errors(backend_acc):
    """Per-particle relative force error against the port's exact direct
    sum (the formula of tests/test_p3m.py::_scene_errors)."""
    w = nt.create_world(nt.make_galaxies(2048, 2, seed=11037), device="cpu")
    pos, rad = w.state.pos, w.state.radius
    src, gm = pos[:w.mass_len], w.gm
    ref = forces.direct_sum_acc(pos, rad, src, gm, precise=True).numpy()
    got = backend_acc(pos, rad, src, gm).numpy()
    mag = np.hypot(ref[:, 0], ref[:, 1])
    return np.hypot(*(got - ref).T) / (mag + 0.01 * mag.mean())


def test_error_envelope_and_beats_pm():
    """The port's copy of tests/test_p3m.py's envelope, same bounds."""
    err_pm = _scene_errors(lambda pos, rad, src, gm: nt.pm_acc(
        pos, src, gm, 2.0, grid=256))
    err_p3m = _scene_errors(lambda pos, rad, src, gm: nt.p3m_acc(
        pos, rad, src, gm, 2.0, grid=256))
    assert np.median(err_p3m) < 2e-3
    assert np.percentile(err_p3m, 99) < 5e-2
    assert err_p3m.max() < 0.12
    assert err_p3m.max() < err_pm.max() / 3.0


def test_exact_core_rows_are_direct_sum_exact():
    """The exact_targets largest-radius rows equal the direct kernel's
    (plain version's) force on them."""
    w = nt.create_world(nt.make_galaxies(1024, 2, seed=7), device="cpu")
    pos, rad, gm = w.state.pos, w.state.radius, w.gm
    src = pos[:w.mass_len]
    got = nt.p3m_acc(pos, rad, src, gm, grid=128, cell_capacity=32,
                     exact_targets=8)
    big = torch.argsort(rad, descending=True, stable=True)[:8]
    want = df.force_acc_plain(pos[big], rad[big], src, gm)
    assert torch.equal(got[big], want)


# World parity: configs of tests/test_p3m.py:112-125 and :351-376 (N=1500,
# one galaxy, grid 256, cap 32), 5 substeps. Tolerances (max|Δ|/max|ref|):
# the per-evaluation force difference of test_p3m_acc_matches_nbody_tpu
# carried through 5 evaluations; measured pos 1.1e-7, vel 2.6e-7, acc
# 2.3e-6 at most over the four cases.
WORLD_TOL = {"pos": 1e-6, "vel": 5e-6, "acc": 2e-5}


@pytest.mark.parametrize("rebin", [1, 4])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_world_p3m_matches_nbody_tpu(integrator, rebin):
    cfg = dict(pm_grid=256, p3m_cell_capacity=32, p3m_rebin_interval=rebin,
               integrator=integrator)
    w_t = nt.create_world(nt.make_galaxies(1500, 1, seed=5),
                          config=nt.SimConfig(**cfg), device="cpu")
    w_j = nb.create_world(nb.make_galaxies(1500, 1, seed=5),
                          config=nb.SimConfig(**cfg))
    w_t.update(0.01, 5, backend="p3m")
    w_j.update(0.01, 5, backend="p3m")
    got, want = w_t.particles, w_j.particles
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(got, name), getattr(want, name))
        assert err < tol, (name, err)


def test_world_p3m_massless_tracers_move_and_stay_finite():
    w = nt.create_world(nt.make_galaxies(800, 2, seed=9), config=nt.SimConfig(
        pm_grid=128, p3m_cell_capacity=32), device="cpu")
    before = w.particles.pos.clone()
    w.update(0.05, 10, backend="p3m")
    after = w.particles.pos
    assert torch.isfinite(after).all()
    tracers = w.particles.mass == 0
    assert (after[tracers] != before[tracers]).any()


def test_cpu_p3m_world_makes_no_kernel_launch():
    before = (df.LAUNCHES, p3m_pp.LAUNCHES)
    w = nt.create_world(nt.make_galaxies(300, 1, seed=1), config=nt.SimConfig(
        pm_grid=64, p3m_cell_capacity=16), device="cpu")
    w.update(0.01, 2, backend="p3m")
    assert (df.LAUNCHES, p3m_pp.LAUNCHES) == before


# --- the direct kernel's source split and the device default ---

@pytest.mark.parametrize("t,s,sms,want", [
    (64, 524_704, 132, 257),      # the exact-core rows at N=1M: 8 tiles each
    (1000, 333, 132, 2),          # 4 target blocks, 2 source tiles
    (65_536, 32_833, 132, 2),     # 256 target blocks < 2 per SM
    (1 << 20, 524_704, 132, 1),   # 4096 target blocks fill the card
    (64, 256, 132, 1),            # one source tile: nothing to split
    (64, 257, 132, 2),
    (0, 1000, 132, 1),
    (64, 0, 132, 1),
])
def test_split_plan(t, s, sms, want):
    n = df._split_plan(t, s, sms)
    assert n == want
    tiles = -(-s // df.TILE)
    if n > 1:   # every range holds at least one tile
        per = -(-tiles // n)
        assert (n - 1) * per < tiles


def test_device_defaults_to_cuda():
    for fn in (nt.World, nt.create_world):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        nt.create_world(nt.make_galaxies(300, 1, seed=1))
