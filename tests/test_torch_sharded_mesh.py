"""The port's sharded mesh solvers (ops/pm_forces.pm_acc_collective,
ops/p3m_forces.p3m_*_collective, ShardedWorld "pm"/"p3m"/"auto",
rollout_sharded "pm"/"p3m") on CPU shards against nbody_tpu's on the
8-device virtual CPU mesh (tests/conftest.py), inputs from a numpy seed.

The collective functions run under ``jax.shard_map`` on the JAX side and
on D CPU shards on the port's, at JAX's own test sizes. The bins must
agree integer for integer; forces carry tests/test_torch_pm.py's and
tests/test_torch_p3m.py's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_helpers import random_arrays, rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu import autodiff as jad
from nbody_tpu.ops import p3m_forces as jp3m
from nbody_tpu.ops import pm_forces as jpm
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu_torch import autodiff as tad
from nbody_tpu_torch import world as tworld
from nbody_tpu_torch.ops import p3m_forces as tp3m
from nbody_tpu_torch.ops import p3m_pp
from nbody_tpu_torch.ops import pm_forces as tpm
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.parallel import sharding as tsh

DS = (1, 2, 4, 8)
PM_TOL = 1e-5       # tests/test_torch_pm.py's TOL
P3M_TOL = 5e-5      # tests/test_torch_p3m.py's pair-correction bound
# tests/test_torch_p3m.py:400's World tolerances (max|Δ|/max|ref|)
WORLD_TOL = {"pos": 1e-6, "vel": 5e-6, "acc": 2e-5}
# JAX's sharded-against-single-device bound (tests/test_p3m.py:166-184)
SCALE_TOL = 2e-6
N_REAL, N_PAD = 1000, 1024
GRID, CAP, EXACT = 128, 8, 16
GC = GRID // 4


def _cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


def _padded_scene(seed=11037):
    """A two-galaxy JAX world's rows (massive first) and 24 padding rows
    (pos 0, radius 1, gm 0, valid 0), as numpy: pos, radius, the gm row,
    valid and mass_len."""
    w = nb.create_world(nb.make_galaxies(N_REAL, 2, seed=seed))
    pos = np.zeros((N_PAD, 2), np.float32)
    pos[:N_REAL] = np.asarray(w.state.pos[:N_REAL])
    rad = np.ones(N_PAD, np.float32)
    rad[:N_REAL] = np.asarray(w.state.radius[:N_REAL])
    gm = np.zeros(N_PAD, np.float32)
    gm[:w.mass_len] = np.asarray(w.gm[:w.mass_len])
    valid = (np.arange(N_PAD) < N_REAL).astype(np.float32)
    return pos, rad, gm, valid, w.mass_len


def _split(a, d):
    n_loc = a.shape[0] // d
    return [torch.from_numpy(np.ascontiguousarray(a[k * n_loc:(k + 1) * n_loc]))
            for k in range(d)]


def _prefix(xs, n_src):
    """Each shard's rows of the first ``n_src`` rows (ShardedWorld's
    sources)."""
    n_loc = xs[0].shape[0]
    return [x[:min(max(n_src - k * n_loc, 0), n_loc)] for k, x in enumerate(xs)]


def _shard_map(body, d, n_in, out_specs=P(jsh.AXIS)):
    specs = (P(jsh.AXIS),) * (n_in - 1) + (P(jsh.AXIS, None),)
    return jax.jit(jax.shard_map(body, mesh=jsh.make_mesh(d), in_specs=specs,
                                 out_specs=out_specs, check_vma=False))


def _cat(xs):
    return torch.cat(list(xs)).numpy()


# --- the collective functions against JAX's under shard_map ---

@pytest.mark.parametrize("d", DS)
def test_pm_acc_collective_matches_nbody_tpu(d):
    """Each shard's own rows are its sources (the gm row zero past
    mass_len), as in nbody_tpu's ShardedWorld "pm"."""
    pos, _, gm, valid, _ = _padded_scene()

    def body(p, g, v):
        return jpm.pm_acc_collective(p, p, g, 2.0, grid=GRID, tgt_mask=v,
                                     axis_name=jsh.AXIS)

    want = np.asarray(_shard_map(body, d, 3)(pos, gm, valid[:, None]))
    ps, gs, vs = (_split(a, d) for a in (pos, gm, valid))
    got = _cat(tpm.pm_acc_collective(ps, ps, gs, 2.0, grid=GRID, tgt_mask=vs))
    real = valid > 0
    assert rel_err(got[real], want[real]) < PM_TOL


def test_pm_acc_collective_sources_are_any_rows():
    """A shard may hold no sources, and the port's shards take only their
    rows of the massive prefix: the same accelerations as every resident
    row with its gm row (zeros add nothing), bit for bit on one shard."""
    pos, _, gm, valid, ml = _padded_scene()
    for d in (1, 4):
        ps, gs, vs = (_split(a, d) for a in (pos, gm, valid))
        full = tpm.pm_acc_collective(ps, ps, gs, 2.0, grid=GRID, tgt_mask=vs)
        pre = tpm.pm_acc_collective(ps, _prefix(ps, ml), _prefix(gs, ml), 2.0,
                                    grid=GRID, tgt_mask=vs)
        assert rel_err(_cat(pre), _cat(full)) < 1e-6
        if d == 1:
            assert np.array_equal(_cat(pre), _cat(full))
    assert any(x.shape[0] == 0 for x in _prefix(_split(pos, 4), ml))


def _jax_bins(d, cap=CAP, exact=EXACT):
    pos, rad, gm, valid, _ = _padded_scene()
    keys = ("order_t", "counts_t", "goff", "order_s", "counts_s",
            "big_i_loc", "big_sel", "big_row")

    def body(p, r, g, v):
        b = jp3m.p3m_bins_collective(
            p, r, g, grid=GRID, rc_cells=4, cell_capacity=cap,
            exact_targets=exact, tgt_mask=v, axis_name=jsh.AXIS, n_devices=d)
        out = {k: b[k] for k in keys}
        if d > 1:
            out["sel"] = b["sel"][None]
        return out

    got = _shard_map(body, d, 4)(pos, rad, gm, valid[:, None])
    return {k: np.asarray(v) for k, v in got.items()}


def _port_bins(d, cap=CAP, exact=EXACT):
    pos, rad, gm, valid, ml = _padded_scene()
    ps, rs, gs, vs = (_split(a, d) for a in (pos, rad, gm, valid))
    return tp3m.p3m_bins_collective(
        ps, rs, _prefix(ps, ml), _prefix(gs, ml), grid=GRID, rc_cells=4,
        cell_capacity=cap, exact_targets=exact, tgt_mask=vs)


def _jax_cell_sources(jb, d, gm, cap=CAP):
    """For each cell, the global rows of the sources that nbody_tpu's
    merged panel keeps (slot order, gm > 0 only): slot j of cell c holds
    sel[c, j] = (shard q) · cap + (its slot m in q's own panel)."""
    n_loc, n_cells = N_PAD // d, GC * GC
    sel = (jb["sel"][0].reshape(n_cells, cap) if d > 1 else
           np.tile(np.arange(cap), (n_cells, 1)))
    out = []
    for c in range(n_cells):
        rows = []
        for v in sel[c]:
            q, m = divmod(int(v), cap)
            counts = jb["counts_s"][q * n_cells:(q + 1) * n_cells]
            start = np.cumsum(counts) - counts
            if m < min(counts[c], cap):
                row = q * n_loc + int(jb["order_s"][q * n_loc + start[c] + m])
                if gm[row] > 0:
                    rows.append(row)
        out.append(rows)
    return out


def _port_cell_sources(tb, cap=CAP):
    order, counts = tb["order_s"][0].numpy(), tb["counts_s"][0].numpy()
    start = np.cumsum(counts) - counts
    return [[int(order[start[c] + j]) for j in range(min(counts[c], cap))]
            for c in range(GC * GC)]


@pytest.mark.parametrize("d", DS)
def test_p3m_bins_collective_match_nbody_tpu(d):
    """Integer for integer: each shard's target order and counts, goff,
    the exact-core candidates, selection and owned rows; and each cell's
    selected sources (the port's global source order, nbody_tpu's per-cell
    top_k over the all-gathered panels) as global rows."""
    jb, tb = _jax_bins(d), _port_bins(d)
    n_loc, n_cells = N_PAD // d, GC * GC
    k = tb["big_sel"].shape[0]
    for s in range(d):
        for key, size in (("order_t", n_loc), ("counts_t", n_cells),
                          ("goff", n_cells), ("big_i_loc", EXACT),
                          ("big_row", k)):
            np.testing.assert_array_equal(
                tb[key][s].numpy(), jb[key][s * size:(s + 1) * size], key)
    np.testing.assert_array_equal(tb["big_sel"].numpy(), jb["big_sel"][:k])
    gm = _padded_scene()[2]
    assert _port_cell_sources(tb) == _jax_cell_sources(jb, d, gm)


@pytest.mark.parametrize("d", [4, 8])
def test_p3m_bins_collective_overflow_spans_shards(d):
    """The case the merge and the drop rule exist for: cells with more than
    ``cap`` sources and more than ``cap`` targets, each spread over two or
    more shards, arise here; in those cells the first cap global sources
    and the global-rank cut of the targets are nbody_tpu's."""
    tb = _port_bins(d)
    ml, n_loc = _padded_scene()[4], N_PAD // d
    counts_t = torch.stack(tb["counts_t"]).numpy()          # (D, cells)
    order_s, counts_s = tb["order_s"][0].numpy(), tb["counts_s"][0].numpy()
    start_s = np.cumsum(counts_s) - counts_s
    src_shard = np.arange(ml) // n_loc
    both = [c for c in range(GC * GC)
            if counts_t[:, c].sum() > CAP and (counts_t[:, c] > 0).sum() >= 2
            and counts_s[c] > CAP
            and len(set(src_shard[order_s[start_s[c]:start_s[c] + counts_s[c]]])) >= 2]
    assert both, "no cell overflows on both sides across shards"
    cut = torch.stack(tb["cut_t"]).numpy()
    for c in both:
        # the cut keeps the first cap targets of the cell in global order
        assert cut[:, c].sum() == CAP
        before = np.concatenate([[0], np.cumsum(counts_t[:-1, c])])
        np.testing.assert_array_equal(
            cut[:, c], np.clip(np.minimum(counts_t[:, c], CAP - before), 0, None))
    jb = _jax_bins(d)
    assert _port_cell_sources(tb) == _jax_cell_sources(jb, d, _padded_scene()[2])


@pytest.mark.parametrize("d", DS)
def test_p3m_acc_collective_matches_nbody_tpu(d):
    """P³M accelerations on the real rows against nbody_tpu's collective,
    cap 8 (cells overflow on both sides), bound 5e-5 of max|ref|; the
    exact-core rows too."""
    pos, rad, gm, valid, ml = _padded_scene()
    kw = dict(grid=GRID, rc_cells=4, cell_capacity=CAP, exact_targets=EXACT)

    def body(p, r, g, v):
        return jp3m.p3m_acc_collective(p, r, g, 2.0, tgt_mask=v,
                                       axis_name=jsh.AXIS, n_devices=d, **kw)

    want = np.asarray(_shard_map(body, d, 4)(pos, rad, gm, valid[:, None]))
    ps, rs, gs, vs = (_split(a, d) for a in (pos, rad, gm, valid))
    got = _cat(tp3m.p3m_acc_collective(ps, rs, _prefix(ps, ml), _prefix(gs, ml),
                                       2.0, tgt_mask=vs, **kw))
    real = valid > 0
    assert rel_err(got[real], want[real]) < P3M_TOL


def test_p3m_acc_collective_one_shard_is_p3m_acc():
    """On one shard the collective is the single-device p3m_acc, bit for
    bit (one grid, nothing to sum; the padding rows add nothing)."""
    pos, rad, gm, valid, ml = _padded_scene()
    kw = dict(grid=GRID, rc_cells=4, cell_capacity=CAP, exact_targets=EXACT)
    t = [torch.from_numpy(a) for a in (pos, rad, gm)]
    want = tp3m.p3m_acc(t[0][:N_REAL], t[1][:N_REAL], t[0][:ml], t[2][:ml],
                        2.0, **kw)
    got = tp3m.p3m_acc_collective([t[0]], [t[1]], [t[0][:ml]], [t[2][:ml]],
                                  2.0, tgt_mask=[torch.from_numpy(valid)], **kw)
    assert torch.equal(got[0][:N_REAL], want)


def test_pp_cells_cut_counts_leave_rows_zero():
    """pp_cells' contract for the drop rule: a count below the run's length
    leaves the rest of the run at 0, and the rows it keeps get the same
    bits as with the whole run (plain version; the card's kernel in
    tests/test_torch_kernels.py)."""
    pos, rad, gm, valid, ml = _padded_scene()
    t = [torch.from_numpy(a) for a in (pos, rad, gm)]
    bins = tp3m.p3m_bins(t[0], t[1], t[0][:ml], t[2][:ml], grid=GRID,
                         rc_cells=4, exact_targets=0)
    trows = tp3m._cell_rows(t[0], t[1] + nb.types.SOFTENING_FLOOR,
                            bins["order_t"])
    srows = tp3m._cell_rows(t[0][:ml], t[2][:ml], bins["order_s"])
    counts = bins["counts_t"]
    cut = torch.clamp(counts - 3, min=0).to(torch.int32)
    args = (trows, srows, bins["start_t"])
    tail = (bins["start_s"], bins["counts_s"], 4 * bins["h"], 4.0)
    whole = p3m_pp.pp_cells(*args, counts, *tail, cap_t=32, cap_s=32)
    part = p3m_pp.pp_cells(*args, cut, *tail, cap_t=32, cap_s=32)
    rank = torch.arange(N_PAD) - bins["start_t"].long().repeat_interleave(
        counts.long())
    kept = rank < cut.long().repeat_interleave(counts.long())
    assert (~kept).any() and (whole[~kept] != 0).any()
    assert torch.equal(part[~kept], torch.zeros_like(part[~kept]))
    assert torch.equal(part[kept], whole[kept])


# --- ShardedWorld "pm" and "p3m" ---

CFG = dict(tile_targets=64, pm_grid=256, p3m_cell_capacity=32)


def _worlds(backend, d, cfg=CFG, n=1024, galaxies=2, seed=11037):
    sw = ShardedWorld(nt.make_galaxies(n, galaxies, seed=seed), _cpu_mesh(d),
                      config=nt.SimConfig(**cfg), force_backend=backend)
    jw = jsh.ShardedWorld(nb.make_galaxies(n, galaxies, seed=seed),
                          jsh.make_mesh(d), config=nb.SimConfig(**cfg),
                          force_backend=backend)
    return sw, jw


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_sharded_world_matches_nbody_tpu(backend, d):
    """3 substeps against nbody_tpu's ShardedWorld at the same D (WORLD_TOL)
    and against the port's World at JAX's 2e-6 of scale; the layout and
    the per-target gm row equal nbody_tpu's."""
    sw, jw = _worlds(backend, d)
    w = nt.create_world(nt.make_galaxies(1024, 2, seed=11037),
                        config=nt.SimConfig(**CFG), device="cpu")
    for name in ("total_len", "mass_len", "src_len", "n_pad", "t_loc", "s_loc"):
        assert getattr(sw, name) == getattr(jw, name), name
    np.testing.assert_array_equal(sw.gm_src.numpy(), np.asarray(jw.gm_src))
    sw.update(0.01, 3)
    jw.update(0.01, 3)
    w.update(0.01, 3, backend=backend)
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(sw.particles, name),
                      np.asarray(getattr(jw.particles, name)))
        assert err < tol, (name, err)
    got, want = sw.particles.pos.numpy(), w.particles.pos.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=SCALE_TOL)


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_sharded_world_one_shard_is_the_world(backend):
    """D=1: a sum over one shard adds nothing and the source rows are the
    World's, so every field is the World's bit for bit."""
    cfg = nt.SimConfig(**CFG, integrator="yoshida4")
    scene = nt.make_galaxies(1000, 2, seed=3)
    sw = ShardedWorld(scene, _cpu_mesh(1), config=cfg, force_backend=backend)
    w = nt.create_world(scene, config=cfg, device="cpu")
    sw.update(0.01, 3)
    w.update(0.01, 3, backend=backend)
    for name in ("pos", "vel", "acc"):
        assert torch.equal(getattr(sw.particles, name),
                           getattr(w.particles, name)), name


def test_sharded_world_runs_are_bit_equal():
    """The shard sums run in a fixed order: two runs give the same bits."""
    runs = []
    for _ in range(2):
        sw = ShardedWorld(nt.make_galaxies(1024, 2, seed=5), _cpu_mesh(4),
                          config=nt.SimConfig(**CFG), force_backend="p3m")
        sw.update(0.01, 3)
        runs.append(sw.particles)
    for name in ("pos", "vel", "acc"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))


# copies of nbody_tpu's sharded tests (tests/test_pm.py, test_p3m.py,
# test_adaptive.py, test_observables.py, test_fuzz.py)

def test_sharded_pm_matches_single_device():
    """tests/test_pm.py:149."""
    scene = nt.make_galaxies(1024, 2, seed=11037)
    cfg = nt.SimConfig(tile_targets=64, pm_grid=256)
    w = nt.create_world(scene, config=cfg, default_backend="pm", device="cpu")
    w.update(0.01, 3)
    b = w.particles.pos.numpy()
    scale = np.abs(b).max()
    for d in (2, 8):
        sw = ShardedWorld(scene, _cpu_mesh(d), config=cfg, force_backend="pm")
        sw.update(0.01, 3)
        np.testing.assert_allclose(sw.particles.pos.numpy() / scale, b / scale,
                                   atol=2e-6)


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_sharded_leapfrog(backend):
    """tests/test_pm.py:167 and tests/test_p3m.py:251."""
    scene = nt.make_galaxies(512, 1, seed=3)
    cfg = nt.SimConfig(tile_targets=64, pm_grid=256 if backend == "pm" else 128,
                       p3m_cell_capacity=32, integrator="leapfrog")
    sw = ShardedWorld(scene, _cpu_mesh(4), config=cfg, force_backend=backend)
    w = nt.create_world(scene, config=cfg, default_backend=backend,
                        device="cpu")
    sw.update(0.01, 4)
    w.update(0.01, 4)
    np.testing.assert_allclose(sw.particles.pos.numpy(), w.particles.pos.numpy(),
                               rtol=3e-4, atol=3e-3)


def test_sharded_p3m_matches_single_device():
    """tests/test_p3m.py:166."""
    scene = nt.make_galaxies(1024, 2, seed=11037)
    cfg = nt.SimConfig(tile_targets=64, pm_grid=256, p3m_cell_capacity=32)
    w = nt.create_world(scene, config=cfg, default_backend="p3m", device="cpu")
    w.update(0.01, 3)
    b = w.particles.pos.numpy()
    scale = np.abs(b).max()
    for d in (2, 8):
        sw = ShardedWorld(scene, _cpu_mesh(d), config=cfg, force_backend="p3m")
        sw.update(0.01, 3)
        np.testing.assert_allclose(sw.particles.pos.numpy() / scale, b / scale,
                                   atol=2e-6)


def test_sharded_p3m_exact_cores_match_direct():
    """tests/test_p3m.py:227: after one Euler substep ``acc`` holds the
    force at the initial positions, direct-sum exact on the 8 cores."""
    scene = nt.make_galaxies(512, 2, seed=7)
    cfg = nt.SimConfig(tile_targets=64, pm_grid=128, p3m_cell_capacity=32,
                       p3m_exact_targets=8)
    w = nt.create_world(scene, config=cfg, device="cpu")
    pos, rad = w.state.pos, w.state.radius
    ref = nt.direct_sum_acc(pos, rad, pos[:w.mass_len], w.gm,
                            precise=False).numpy()
    sw = ShardedWorld(scene, _cpu_mesh(4), config=cfg, force_backend="p3m")
    sw.update(0.01, 1)
    acc = sw.particles.acc.numpy()
    big = np.argsort(-rad.numpy(), kind="stable")[:8]
    scale = np.abs(ref[big]).max()
    np.testing.assert_allclose(acc[big] / scale, ref[big] / scale, atol=1e-5)


def test_sharded_p3m_record():
    """tests/test_p3m.py:266, the capture half (Orbax is not ported): the
    record of 3 frames of 2 substeps ends where a World's 6 substeps do."""
    scene = nt.make_galaxies(512, 1, seed=11)
    cfg = nt.SimConfig(tile_targets=64, pm_grid=128, p3m_cell_capacity=32)
    sw = ShardedWorld(scene, _cpu_mesh(4), config=cfg, force_backend="p3m")
    traj = sw.record(0.01, frames=3, steps_per_frame=2)
    assert traj.shape == (3, sw.total_len, 2) and np.isfinite(traj).all()
    w = nt.create_world(scene, config=cfg, default_backend="p3m", device="cpu")
    w.update(0.01, 6)
    scale = np.abs(traj[-1]).max()
    np.testing.assert_allclose(traj[-1] / scale, w.particles.pos.numpy() / scale,
                               atol=2e-6)


def test_sharded_p3m_rebin_tracks_exact():
    """tests/test_p3m.py:378: frozen collective bins for 4 substeps track
    the rebuilt-every-substep run, and match the World's rebin run."""
    scene = nt.make_galaxies(768, 1, seed=3)
    base = dict(tile_targets=64, pm_grid=128, p3m_cell_capacity=32)
    sw1 = ShardedWorld(scene, _cpu_mesh(4), config=nt.SimConfig(**base),
                       force_backend="p3m")
    sw4 = ShardedWorld(scene, _cpu_mesh(4),
                       config=nt.SimConfig(**base, p3m_rebin_interval=4),
                       force_backend="p3m")
    sw1.update(0.01, 12)
    sw4.update(0.01, 12)
    a, b = sw1.particles.pos.numpy(), sw4.particles.pos.numpy()
    scale = np.abs(a).max()
    assert np.max(np.abs(a - b)) / scale < 2e-4
    w4 = nt.create_world(scene, config=nt.SimConfig(**base, p3m_rebin_interval=4),
                         default_backend="p3m", device="cpu")
    w4.update(0.01, 12)
    np.testing.assert_allclose(b / scale, w4.particles.pos.numpy() / scale,
                               atol=2e-6)


def test_sharded_adaptive_with_hook_pm():
    """tests/test_adaptive.py:136, and the substep count nbody_tpu's."""
    cfg = dict(tile_targets=128, pm_grid=128)
    sw = ShardedWorld(nt.make_galaxies(256, 1, seed=17), _cpu_mesh(4),
                      config=nt.SimConfig(**cfg), force_backend="pm")
    jw = jsh.ShardedWorld(nb.make_galaxies(256, 1, seed=17), jsh.make_mesh(4),
                          config=nb.SimConfig(**cfg), force_backend="pm")
    n = sw.update_adaptive(0.02, dt_max=0.01, extra_force=lambda p, v: -0.1 * v)
    assert n >= 2
    assert np.isfinite(sw.particles.pos.numpy()).all()
    assert n == jw.update_adaptive(0.02, dt_max=0.01,
                                   extra_force=lambda p, v: -0.1 * v)
    assert rel_err(sw.particles.pos, np.asarray(jw.particles.pos)) < WORLD_TOL["pos"]


def test_sharded_observables_pm_and_record_still_works():
    """tests/test_observables.py:151."""
    tiny = nt.SimConfig(tile_targets=8, tile_sources=128)
    sw = ShardedWorld(nt.make_galaxies(400, 1, seed=13), _cpu_mesh(2),
                      config=tiny, force_backend="pm")
    obs = sw.record_observables(0.01, frames=2, energy="pm", pm_grid=128)
    assert obs["potential"].shape == (2,) and np.isfinite(obs["potential"]).all()
    traj = sw.record(0.01, frames=2)
    assert traj.shape == (2, 400, 2)


@pytest.mark.parametrize("seed", range(4))
def test_random_sharded_p3m_matches_single(seed):
    """tests/test_fuzz.py:99, with the port's World as the single device:
    random worlds, D and rebin interval drawn, cells overflowing."""
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(16, 300))
    d = int(rng.choice([2, 4, 8]))
    rebin = int(rng.choice([1, 3]))
    pos, vel, mass, radius = random_arrays(n, seed=300 + seed)
    p = nt.make_particles(pos, vel=vel, mass=mass, radius=radius)
    dt = float(rng.uniform(0.001, 0.03))
    cfg = nt.SimConfig(tile_targets=64, pm_grid=64, p3m_cell_capacity=8,
                       p3m_exact_targets=4, p3m_rebin_interval=rebin)
    w = nt.create_world(p, config=cfg, default_backend="p3m", device="cpu")
    sw = ShardedWorld(p, _cpu_mesh(d), config=cfg, force_backend="p3m")
    w.update(dt, 4)
    sw.update(dt, 4)
    a, b = w.particles.pos.numpy(), sw.particles.pos.numpy()
    assert np.all(np.isfinite(b))
    scale = max(1.0, np.abs(a).max())
    assert np.abs(a - b).max() / scale < 5e-6, (d, rebin)


@pytest.mark.parametrize("integrator", ["euler", "yoshida4"])
def test_sharded_hooked_p3m_matches_nbody_tpu(integrator):
    """A hook composed per shard (masked by valid) on the collective p3m."""
    cfg = dict(CFG, integrator=integrator)
    sw = ShardedWorld(nt.make_galaxies(1024, 2, seed=9), _cpu_mesh(4),
                      config=nt.SimConfig(**cfg), force_backend="p3m")
    jw = jsh.ShardedWorld(nb.make_galaxies(1024, 2, seed=9), jsh.make_mesh(4),
                          config=nb.SimConfig(**cfg), force_backend="p3m")
    sw.update(0.01, 2, extra_force=lambda p, v: -0.1 * v)
    jw.update(0.01, 2, extra_force=lambda p, v: -0.1 * v)
    for name, tol in WORLD_TOL.items():
        assert rel_err(getattr(sw.particles, name),
                       np.asarray(getattr(jw.particles, name))) < tol, name


# --- merging on "pm" ---

def _accreting(n=300, seed=8):
    rng = np.random.default_rng(seed)
    k = n // 2
    pos = np.concatenate([rng.uniform(-4, 4, (k, 2)),
                          rng.uniform(-40, 40, (n - k, 2))]).astype(np.float32)
    mass = np.concatenate([rng.uniform(0.5, 2.0, k), np.zeros(n - k)])
    radius = np.concatenate([np.full(k, 0.4), np.full(n - k, 0.5)])
    vel = rng.normal(0, 0.2, (n, 2))
    return [np.asarray(a, np.float32) for a in (pos, vel, mass, radius)]


def test_sharded_pm_merging_matches_nbody_tpu():
    """20 merging substeps of a dense cluster on 4 shards: the same merges
    as nbody_tpu's 4-device "pm" world (masses and the gm row equal), the
    positions within the merging tests' 1e-5 of max|pos|."""
    pos, vel, mass, radius = _accreting()
    cfg = dict(tile_targets=8, tile_sources=128, pm_grid=128,
               merge_collisions=True)
    sw = ShardedWorld(nt.make_particles(pos, vel=vel, mass=mass, radius=radius),
                      _cpu_mesh(4), config=nt.SimConfig(**cfg),
                      force_backend="pm")
    jw = jsh.ShardedWorld(nb.make_particles(pos, vel=vel, mass=mass,
                                            radius=radius),
                          jsh.make_mesh(4), config=nb.SimConfig(**cfg),
                          force_backend="pm")
    sw.update(0.01, 20)
    jw.update(0.01, 20)
    got, want = sw.particles, jw.particles
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    np.testing.assert_array_equal(sw.gm_src.numpy(), np.asarray(jw.gm_src))
    assert (got.mass.numpy()[:sw.mass_len] == 0).sum() > 20
    assert rel_err(got.pos, np.asarray(want.pos)) < 1e-5


def test_sharded_pm_merge_record_and_adaptive():
    """tests/test_collisions.py:348 on "pm": capture and the adaptive loop
    run through the merges, and the adaptive count is nbody_tpu's."""
    pos = np.array([[0.0, 0.0], [1.0, 0.0], [10.0, 10.0]], np.float32)
    mass = np.array([5.0, 3.0, 0.0], np.float32)
    radius = np.array([0.7, 0.7, 0.5], np.float32)
    cfg = dict(tile_targets=8, tile_sources=128, pm_grid=64,
               merge_collisions=True)

    def port():
        return ShardedWorld(nt.make_particles(pos, mass=mass, radius=radius),
                            _cpu_mesh(2), config=nt.SimConfig(**cfg),
                            force_backend="pm")

    sw = port()
    traj = sw.record(0.01, frames=3, steps_per_frame=2)
    assert traj.shape == (3, 3, 2) and np.isfinite(traj).all()
    assert float(sw.particles.mass[0]) == pytest.approx(8.0)
    sw2 = port()
    n = sw2.update_adaptive(0.01, dt_max=5e-3)
    jw = jsh.ShardedWorld(nb.make_particles(pos, mass=mass, radius=radius),
                          jsh.make_mesh(2), config=nb.SimConfig(**cfg),
                          force_backend="pm")
    assert n >= 2 and n == jw.update_adaptive(0.01, dt_max=5e-3)
    np.testing.assert_array_equal(sw2.particles.mass.numpy(),
                                  np.asarray(jw.particles.mass))
    assert np.isfinite(sw2.particles.pos.numpy()).all()


# --- "auto", from_arrays, the CLI ---

def test_auto_is_nbody_tpus_per_chip_rule(monkeypatch):
    """The port's resolution against nbody_tpu's _default_force_backend on
    CPU shards ("torch" is "jnp"), both modules' crossover set to one value
    (after A6 the two numbers differ by design)."""
    import nbody_tpu.world as jworld

    monkeypatch.setattr(tworld, "AUTO_P3M_MIN_PAIRS", 10 ** 8)
    monkeypatch.setattr(jworld, "AUTO_P3M_MIN_PAIRS", 10 ** 8)
    names = {"jnp": "torch"}
    for n in (1000, 20_000, 100_000):
        for mass_len in (0, n // 3, n):
            for d in (1, 2, 4, 8):
                for merging in (False, True):
                    want = jsh._default_force_backend("auto", n, mass_len, d,
                                                      merging=merging)
                    got = tsh.resolve_force_backend(
                        "auto", _cpu_mesh(d), n, mass_len, merging=merging)
                    assert got == names.get(want, want), (n, mass_len, d)
                    # D shards on D cards are nbody_tpu's D chips; D shards
                    # on one card are one chip (the rule is not asked to
                    # touch the card: it reads the devices alone)
                    cards = [torch.device("cuda", i) for i in range(d)]
                    got = tsh.resolve_force_backend(
                        "auto", cards, n, mass_len, merging=merging)
                    assert got == {"jnp": "cuda"}.get(want, want), (n, d)
                    one = jsh._default_force_backend("auto", n, mass_len, 1,
                                                     merging=merging)
                    got = tsh.resolve_force_backend(
                        "auto", cards[:1] * d, n, mass_len, merging=merging)
                    assert got == {"jnp": "cuda"}.get(one, one), (n, d)


@pytest.mark.parametrize("shards,cards,want", [
    (1, 1, "p3m"), (4, 1, "p3m"), (4, 2, "p3m"), (4, 4, "cuda"),
    (8, 4, "cuda")])
def test_auto_counts_cards_not_shards(shards, cards, want):
    """At N=262144 (mass_len 131072: 3.4e10 pairs, 8.6e9 a shard at D=4)
    the direct sum on one H100 is ~3x slower than p3m, so D=4 shards that
    share one card must resolve to "p3m"; only four cards split the work."""
    mesh = [torch.device("cuda", k % cards) for k in range(shards)]
    assert tsh.mesh_chips(mesh) == cards
    assert tsh.mesh_chips(_cpu_mesh(shards)) == shards
    assert tsh.resolve_force_backend("auto", mesh, 262144, 131072) == want


def test_auto_world_picks_by_the_crossover(monkeypatch):
    scene = nt.make_galaxies(2000, 2, seed=1)
    ml = int((scene.mass > 0).sum())
    monkeypatch.setattr(tworld, "AUTO_P3M_MIN_PAIRS", 2000 * ml // 4)
    assert ShardedWorld(scene, _cpu_mesh(4), force_backend="auto").force_backend == "torch"
    assert ShardedWorld(scene, _cpu_mesh(2), force_backend="auto").force_backend == "p3m"
    merging = nt.SimConfig(merge_collisions=True)
    assert ShardedWorld(scene, _cpu_mesh(2), config=merging,
                        force_backend="auto").force_backend == "pm"


@pytest.mark.parametrize("backend", ["torch", "cuda_ring", "pm", "p3m"])
def test_from_arrays_steps_bit_equal(backend):
    """A world rebuilt from its padded shards steps bit-equal to the
    original, on every backend that runs on CPU shards."""
    cfg = nt.SimConfig(**CFG)
    sw = ShardedWorld(nt.make_galaxies(1000, 2, seed=4), _cpu_mesh(4),
                      config=cfg, force_backend=backend)
    sw.update(0.01, 2)
    st = sw.state
    rebuilt = ShardedWorld.from_arrays(
        sw.pos, sw.vel, sw.acc, sw.mass, sw.radius, total_len=sw.total_len,
        mass_len=sw.mass_len, mesh=_cpu_mesh(4), config=cfg,
        force_backend=backend)
    np.testing.assert_array_equal(rebuilt.gm_src.numpy(), sw.gm_src.numpy())
    again = ShardedWorld.from_arrays(
        st.pos, st.vel, st.acc, st.mass, st.radius, total_len=sw.total_len,
        mass_len=sw.mass_len, mesh=_cpu_mesh(4), config=cfg,
        force_backend=backend)
    for w in (sw, rebuilt, again):
        w.update(0.01, 2)
    for name in ("pos", "vel", "acc"):
        assert torch.equal(getattr(rebuilt.particles, name),
                           getattr(sw.particles, name)), name
        assert torch.equal(getattr(again.particles, name),
                           getattr(sw.particles, name)), name
    with pytest.raises(ValueError, match="does not match the layout"):
        ShardedWorld.from_arrays(st.pos[:-8], st.vel, st.acc, st.mass,
                                 st.radius, total_len=sw.total_len,
                                 mass_len=sw.mass_len, mesh=_cpu_mesh(4),
                                 config=cfg)


def test_cli_run_shard_p3m_saves(tmp_path):
    from nbody_tpu_torch import app
    from nbody_tpu_torch.utils.checkpoint import load_particles

    out = tmp_path / "s.npz"
    app.main(["--platform", "cpu", "run", "--n", "600", "--galaxies", "2",
              "--steps", "3", "--shard", "--backend", "p3m", "--pm-grid",
              "128", "--save", str(out)])
    particles, extra = load_particles(str(out))
    assert particles.pos.shape == (600, 2)
    assert np.isfinite(np.asarray(particles.pos)).all()


# --- rollout_sharded "pm" and "p3m" ---

def _galaxy_state(n, seed):
    w = nb.create_world(nb.make_galaxies(n, 1, seed=seed))
    return [np.array(getattr(w.state, f)[:n]) for f in
            ("pos", "vel", "mass", "radius")], w.mass_len


@pytest.mark.parametrize("backend", ["pm", "p3m"])
def test_rollout_sharded_mesh_matches_nbody_tpu(backend):
    """Value and gradient of sum(pos²) after 3 steps on 4 CPU shards
    against nbody_tpu's rollout_sharded on its 4-device mesh, at the
    sharded ring's bounds (value 1e-5 relative, gradient 3e-5 of max)."""
    (pos, vel, mass, radius), ml = _galaxy_state(500, 4)
    kw = dict(n_steps=3, mass_len=ml, pm_grid=128, backend=backend)
    if backend == "p3m":
        kw["p3m_cell_capacity"] = 32

    def T(a):
        return torch.tensor(a)

    p0 = torch.tensor(pos, requires_grad=True)
    a, _ = tad.rollout_sharded(p0, T(vel), T(mass), T(radius), 0.01,
                               mesh=["cpu"] * 4, **kw)
    v_t = torch.sum(a ** 2)
    (g_t,) = torch.autograd.grad(v_t, p0)

    def loss_j(p):
        b, _ = jad.rollout_sharded(p, jnp.asarray(vel), jnp.asarray(mass),
                                   jnp.asarray(radius), 0.01,
                                   mesh=jsh.make_mesh(4), **kw)
        return jnp.sum(b ** 2)

    v_j, g_j = jax.value_and_grad(loss_j)(jnp.asarray(pos))
    assert v_t.item() == pytest.approx(float(v_j), rel=1e-5)
    assert rel_err(g_t, g_j) < 3e-5
