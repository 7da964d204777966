"""Collision merging (``SimConfig.merge_collisions``) in the port, on the CPU:
the cases of tests/test_collisions.py and
tests/test_adaptive.py::test_composes_with_merging, each held against
nbody_tpu on the same numpy inputs.

Bounds: the merge pass is bit-equal to nbody_tpu's (both CPUs scatter
serially in row order and divide by IEEE rules) except the radius, whose
cube root ``r3 ** (1/3)`` is each library's pow, held to 2 ulp. Worlds
use tests/test_collisions.py's bounds: masses equal, positions within
1e-5 of max|pos|, gm against g·mass with rtol 1e-6, mass conserved to
rel 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.ops.collisions import merge_pass as jax_merge_pass
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu_torch import forces
from nbody_tpu_torch.ops import collisions as col
from nbody_tpu_torch.ops.pm_forces import _cic_scatter
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.utils import contact_scenes
from nbody_tpu_torch.utils.checks import validate_world_invariants

TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128)
MERGE = dataclasses.replace(TINY, merge_collisions=True)
MERGE_JAX = dataclasses.replace(TINY_JAX, merge_collisions=True)
DT = 1e-4  # tiny: merge geometry dominates, gravity barely moves anything
POS_TOL = 1e-5   # of max|pos| (tests/test_collisions.py:329-346)
RADIUS_ULP = 2


def _arrays(pos, mass, radius, vel=None):
    pos = np.asarray(pos, np.float32)
    vel = np.zeros_like(pos) if vel is None else np.asarray(vel, np.float32)
    return pos, vel, np.asarray(mass, np.float32), np.asarray(radius, np.float32)


def _worlds(pos, mass, radius, vel=None, config=MERGE, jconfig=MERGE_JAX):
    """The same scene as a port World on the CPU and an nbody_tpu World."""
    pos, vel, mass, radius = _arrays(pos, mass, radius, vel)
    w = nt.create_world(nt.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius),
                        config=config, device="cpu")
    j = nb.create_world(nb.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius), config=jconfig)
    return w, j


def _cluster(n=64, seed=1, spread=3.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-spread, spread, (n, 2)), rng.uniform(0.5, 2.0, n),
            np.full(n, 0.4), rng.normal(0, 0.2, (n, 2)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _assert_close_worlds(w, j):
    p, q = w.particles, j.particles
    np.testing.assert_array_equal(p.mass.numpy(), np.asarray(q.mass))
    ref = np.asarray(q.pos, np.float64)
    err = np.abs(p.pos.numpy() - ref).max() / np.abs(ref).max()
    assert err < POS_TOL, err


def _assert_gm_tracks_mass(w):
    gm = w.gm.numpy()
    np.testing.assert_allclose(gm, 10.0 * w.particles.mass.numpy()[:w.mass_len],
                               rtol=1e-6)


# --- the pass -----------------------------------------------------------

def _pass_inputs(kind):
    rng = np.random.default_rng(3)
    if kind == "cluster":          # ties every 7th row, a dead row
        n = 300
        pos = rng.uniform(-6, 6, (n, 2))
        mass = rng.uniform(0.5, 2.0, n)
        mass[::7] = mass[3]
        gm_dead = [5]
    elif kind == "multi_tile":     # M = 1100, not a multiple of the chunk
        n = 1100
        pos = rng.uniform(-14, 14, (n, 2))
        mass = rng.uniform(0.5, 2.0, n)
        gm_dead = []
    elif kind == "chain":          # A < B < C < D in a row
        pos = [[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0], [40.0, 0.0]]
        mass = [1.0, 2.0, 4.0, 8.0, 3.0]
        n = 5
        gm_dead = []
    else:                          # equal masses on the boundary d = r_i + r_j
        pos = [[0.0, 0.0], [1.0, 0.0], [0.0, 0.75], [3.0, 3.0]]
        mass = [3.0, 3.0, 3.0, 3.0]
        n = 4
        gm_dead = []
    radius = np.full(n, {"cluster": 0.4, "multi_tile": 0.4, "chain": 0.6}.get(
        kind, 0.5))
    pos, vel, mass, radius = _arrays(pos, mass, radius,
                                     rng.normal(0, 0.2, (n, 2)))
    gm = (np.float32(10.0) * mass).astype(np.float32)
    gm[gm_dead] = 0.0
    return pos, vel, radius, mass, gm


KINDS = ["cluster", "multi_tile", "chain", "boundary"]


@pytest.mark.parametrize("kind", KINDS)
def test_merge_pass_matches_nbody_tpu(kind):
    pos, vel, radius, mass, gm = _pass_inputs(kind)
    want = [np.asarray(x) for x in jax_merge_pass(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius),
        jnp.asarray(mass), jnp.asarray(gm), factor=1.0, g=10.0,
        chunk=min(512, len(gm)))]
    t = [torch.from_numpy(x) for x in (pos, vel, radius, mass, gm)]
    got = [x.numpy() for x in col.merge_pass(*t, factor=1.0, g=10.0)]
    for name, a, b in zip(("pos", "vel", "radius", "mass", "gm"), got, want):
        if name == "radius":
            assert _ulps(a, b) <= RADIUS_ULP, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got[3] == 0).sum() > (mass == 0).sum()   # something merged


def _contacts_reference(pos, radius, mass, live, factor):
    """The contact rule in numpy fp32, pair by pair."""
    m = len(mass)
    f = np.float32(factor)
    is_loser = np.zeros(m, bool)
    winner = np.full(m, m, np.int64)
    for i in range(m):
        dx = pos[i, 0] - pos[:, 0]
        dy = pos[i, 1] - pos[:, 1]
        d2 = dx * dx + dy * dy
        reach = f * (radius[i] + radius)
        j = np.arange(m)
        beats = (mass > mass[i]) | ((mass == mass[i]) & (j < i))
        c = (d2 < reach * reach) & live[i] & live & (j != i) & beats
        if c.any():
            best = mass[c].max()
            is_loser[i] = True
            winner[i] = j[c & (mass == best)].min()
    return is_loser, winner


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk", [1, 7, None])
def test_contacts_plain_follows_the_rule_at_any_chunk(kind, chunk):
    pos, _, radius, mass, gm = _pass_inputs(kind)
    live = gm > 0
    want = _contacts_reference(pos, radius, mass, live, 1.0)
    t = [torch.from_numpy(x) for x in (pos, radius, mass)]
    got = col.contacts_plain(*t, torch.from_numpy(live), 1.0, chunk=chunk)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    # the wrapper takes the plain version on CPU tensors
    wrapped = col.contacts(*t, torch.from_numpy(live), 1.0)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def test_contact_on_the_boundary_is_no_contact():
    """|d| = r_i + r_j exactly (d2 == reach²) is no contact: strict <."""
    pos, _, radius, mass, gm = _pass_inputs("boundary")
    t = [torch.from_numpy(x) for x in (pos, radius, mass)]
    is_loser, winner = col.contacts(*t, torch.from_numpy(gm > 0), 1.0)
    # rows 0 and 1 touch exactly; rows 0 and 2 overlap (0 wins, lower index)
    assert is_loser.tolist() == [False, False, True, False]
    assert winner.tolist() == [4, 4, 0, 4]


# --- the contact search's grid (the kernel's pairs, in plain PyTorch) ----

def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", contact_scenes.KINDS)
@pytest.mark.parametrize("factor", [1.0, 1.5])
def test_grid_search_is_contacts_plain_bit_for_bit(kind, factor):
    """The kernel's candidate pairs (contacts_grid_plain) give
    contacts_plain's answer on the scenes where the grid is tight."""
    scene = contact_scenes.contact_scene(kind)
    want = col.contacts_plain(*scene, factor)
    assert _same(col.contacts_grid_plain(*scene, factor), want)
    assert int(want[0].sum()) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_grid_search_on_the_pass_inputs(kind):
    pos, _, radius, mass, gm = _pass_inputs(kind)
    t = [torch.from_numpy(x) for x in (pos, radius, mass)] + [
        torch.from_numpy(gm > 0)]
    for big_rows in (1, 3, None):
        assert _same(col.contacts_grid_plain(*t, 1.0, big_rows=big_rows),
                     col.contacts_plain(*t, 1.0))


@pytest.mark.parametrize("margin,loses", [(None, False), (1 - 2**-20, True)])
def test_grid_misses_no_contact_where_the_margin_is_tight(monkeypatch, margin,
                                                          loses):
    """Pairs one ulp inside reach, the first row just below a cell's edge:
    the grid's margin keeps them adjacent; cells narrower than reach (a
    margin of 1 - 2^-20) would lose them, so the scene can tell."""
    scene = contact_scenes.tight_margin_scene(margin)
    if margin is not None:
        monkeypatch.setattr(col, "CELL_MARGIN", margin)
    want = col.contacts_plain(*scene, 1.0)
    assert int(want[0].sum()) == 7
    assert _same(col.contacts_grid_plain(*scene, 1.0), want) is not loses


def test_grid_holds_what_the_kernel_assumes():
    """The big rows are the fewer than K rows whose size (|r| if live)
    exceeds the K-th largest, r_cut; every row on the grid is live, not
    big, at a finite position, with |r| <= r_cut, in the cell its key
    names from the origin (the least x and y of the live finite rows);
    keys sorted, order a permutation; cells wider than reach."""
    pos, radius, mass, live = contact_scenes.contact_scene("far_and_big")
    radius[7] = -30.0                                  # |r| counts
    pos[9, 0] = float("nan")
    grid = col.contact_grid(pos, radius, live, 1.0)
    size = torch.where(live, radius.abs(), float("-inf"))
    r_cut = torch.sort(size, descending=True).values[col.BIG_ROWS - 1]
    assert torch.equal(grid.big, size > r_cut)
    assert 0 < int(grid.big.sum()) < col.BIG_ROWS
    assert bool(grid.big[7]) == bool(live[7])
    assert torch.equal(torch.sort(grid.order).values, torch.arange(len(mass)))
    assert bool((grid.keys[1:] >= grid.keys[:-1]).all())
    on = torch.zeros(len(mass), dtype=torch.bool)
    on[grid.order] = grid.keys != col.OFF_GRID
    assert not on[grid.big].any() and not on[9] and not on[~live].any()
    assert bool((radius.abs()[on] <= r_cut).all())
    seen = live.clone()
    seen[9] = False
    assert torch.equal(grid.origin, pos[seen].double().amin(0))
    rows = grid.order[grid.keys != col.OFF_GRID]
    keys = grid.keys[grid.keys != col.OFF_GRID]
    cell = ((pos[rows].double() - grid.origin) / grid.width).floor().long()
    assert torch.equal(keys, (cell[:, 1] << 32) | cell[:, 0])
    assert float(grid.width) > 2.0 * float(r_cut)


def test_grid_search_with_non_finite_and_negative_rows():
    rng = np.random.default_rng(8)
    n = 600
    pos = rng.uniform(-8.0, 8.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.1, 0.6, n).astype(np.float32)
    pos[3] = np.inf
    pos[4, 1] = np.nan
    radius[5] = np.nan
    radius[6] = -0.7
    radius[10:40] = 2.0                                # ties among big rows
    mass = (np.round(rng.uniform(0.5, 2.0, n) * 4) / 4).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    t = [torch.from_numpy(x) for x in (pos, radius, mass, live)]
    for factor in (1.0, 0.5, 2.0):
        assert _same(col.contacts_grid_plain(*t, factor),
                     col.contacts_plain(*t, factor))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 300),
       spread=st.floats(0.5, 40.0), offset=st.sampled_from([0.0, -7e3, 1e6]),
       factor=st.sampled_from([1.0, 0.75, 1.5]), big=st.integers(0, 5),
       big_rows=st.sampled_from([1, 4, 32]))
def test_grid_search_on_random_clusters(seed, n, spread, offset, factor, big,
                                        big_rows):
    """Random clusters (some dead rows, tied masses, a few large radii,
    far from the origin) through the kernel's pairs: contacts_plain's
    answer, bit for bit."""
    rng = np.random.default_rng(seed)
    pos = (offset + rng.uniform(-spread, spread, (n, 2))).astype(np.float32)
    radius = rng.uniform(0.05, 1.0, n).astype(np.float32)
    radius[:big] = rng.uniform(2.0, 30.0, min(big, n))
    mass = (np.round(rng.uniform(0.5, 2.0, n) * 4) / 4).astype(np.float32)
    live = rng.uniform(size=n) > 0.1
    t = [torch.from_numpy(x) for x in (pos, radius, mass, live)]
    assert _same(col.contacts_grid_plain(*t, factor, big_rows=big_rows),
                 col.contacts_plain(*t, factor))


def test_merge_pass_plain_is_the_pass():
    pos, vel, radius, mass, gm = _pass_inputs("multi_tile")
    t = [torch.from_numpy(x) for x in (pos, vel, radius, mass, gm)]
    a = col.merge_pass(*t, factor=1.0, g=10.0)
    b = col.merge_pass_plain(*t, factor=1.0, g=10.0, chunk=100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_merge_pass_leaves_rows_past_the_prefix_and_its_inputs():
    pos, vel, radius, mass, gm = _pass_inputs("cluster")
    t = [torch.from_numpy(x.copy()) for x in (pos, vel, radius, mass)]
    before = [x.clone() for x in t]
    m = 200
    out = col.merge_pass(*t, torch.from_numpy(gm[:m].copy()), factor=1.0,
                         g=10.0)
    assert all(torch.equal(x, y) for x, y in zip(t, before))
    for x, y in zip(out[:4], before):
        assert torch.equal(x[m:], y[m:])
    assert out[4].shape == (m,)


def test_empty_prefix_is_a_no_op():
    t = [torch.zeros(3, 2), torch.zeros(3, 2), torch.ones(3), torch.zeros(3)]
    out = col.merge_pass(*t, torch.zeros(0), factor=1.0, g=10.0)
    assert all(torch.equal(x, y) for x, y in zip(out[:4], t))


@pytest.mark.parametrize("two_d", [False, True])
def test_add_at_is_the_serial_scatter(two_d):
    """C5: above 32768 entries PyTorch's CPU ``index_put_(accumulate=True)``
    adds by float atomics across threads; ``forces.add_at`` keeps the
    serial row order of ``np.add.at`` (and of XLA's CPU scatter)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rng = np.random.default_rng(0)
        n = 1 << 16
        idx = rng.integers(0, 64, n)
        shape = (n, 2) if two_d else (n,)
        val = (rng.standard_normal(shape)
               * 10.0 ** rng.integers(-6, 6, shape)).astype(np.float32)
        want = np.zeros((64,) + shape[1:], np.float32)
        np.add.at(want, idx, val)
        got = torch.zeros(want.shape)
        forces.add_at(got, torch.from_numpy(idx), torch.from_numpy(val))
        np.testing.assert_array_equal(got.numpy(), want)
    finally:
        torch.set_num_threads(threads)


def test_cic_scatter_is_the_serial_scatter():
    """C5 on the mesh: 8192 sources give 32768 CIC entries."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rng = np.random.default_rng(1)
        pos = rng.uniform(0, 1, (8192, 2)).astype(np.float32)
        gm = rng.uniform(0.5, 2, 8192).astype(np.float32)
        lo = torch.zeros(2)
        grid = 64
        rho = _cic_scatter(torch.from_numpy(pos), torch.from_numpy(gm), lo,
                           torch.tensor(60.0), grid).numpy().reshape(-1)
        from nbody_tpu_torch.ops.pm_forces import _cic_weights

        i0, j0, wx, wy = (x.numpy() for x in _cic_weights(
            torch.from_numpy(pos), lo, torch.tensor(60.0), grid))
        c = i0 * grid + j0
        cells = np.concatenate([c, c + grid, c + 1, c + grid + 1])
        g = torch.from_numpy(gm)
        wx, wy = torch.from_numpy(wx), torch.from_numpy(wy)
        mass = torch.cat([g * ((1 - wx) * (1 - wy)), g * (wx * (1 - wy)),
                          g * ((1 - wx) * wy), g * (wx * wy)]).numpy()
        want = np.zeros(grid * grid, np.float32)
        np.add.at(want, cells, mass)
        np.testing.assert_array_equal(rho, want)
    finally:
        torch.set_num_threads(threads)


# --- World (tests/test_collisions.py) -------------------------------------

def test_two_body_merge_conserves_everything():
    w, j = _worlds([[0.0, 0.0], [1.0, 0.0]], mass=[5.0, 3.0], radius=[0.7, 0.7])
    w.update(DT, 1, backend="torch")
    j.update(DT, 1, backend="jnp")
    p = w.particles
    assert float(p.mass[0]) == pytest.approx(8.0) and float(p.mass[1]) == 0.0
    assert float(p.pos[0, 0]) == pytest.approx(3.0 / 8.0, abs=1e-4)
    mom = (p.mass[:, None] * p.vel).sum(0)
    assert float(mom.abs().max()) < 1e-5
    assert float(p.radius[0]) == pytest.approx((2 * 0.7**3) ** (1 / 3), rel=1e-5)
    assert float(p.radius[1]) == pytest.approx(0.5)
    assert torch.equal(p.pos[1], p.pos[0]) and torch.equal(p.vel[1], p.vel[0])
    _assert_close_worlds(w, j)


def test_equal_masses_lower_index_wins():
    w, _ = _worlds([[0.0, 0.0], [1.0, 0.0]], mass=[3.0, 3.0], radius=[0.7, 0.7])
    w.update(DT, 1, backend="torch")
    assert w.particles.mass.tolist() == [6.0, 0.0]


def test_chain_defers_one_substep():
    w, j = _worlds([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]],
                   mass=[1.0, 2.0, 4.0], radius=[0.6, 0.6, 0.6])
    w.update(DT, 1, backend="torch")
    j.update(DT, 1, backend="jnp")
    assert w.particles.mass.tolist() == [1.0, 0.0, 6.0]
    _assert_close_worlds(w, j)


def test_contact_free_world_is_bit_identical():
    scene = nt.make_galaxies(250, 1, seed=5)
    a = nt.create_world(scene, config=MERGE, device="cpu")
    b = nt.create_world(scene, config=TINY, device="cpu")
    a.update(0.01, 3, backend="torch")
    b.update(0.01, 3, backend="torch")
    assert torch.equal(a.particles.pos, b.particles.pos)
    assert torch.equal(a.particles.mass, b.particles.mass)


def test_merges_conserve_momentum_exactly():
    pos, mass, radius, vel = _cluster()
    w, j = _worlds(pos, mass, radius, vel,
                   config=dataclasses.replace(MERGE, g=1e-12),
                   jconfig=dataclasses.replace(MERGE_JAX, g=1e-12))
    m0 = float(w.particles.mass.sum())
    p0 = (w.particles.mass[:, None] * w.particles.vel).sum(0)
    w.update(0.05, 40, backend="torch")
    j.update(0.05, 40, backend="jnp")
    p = w.particles
    assert int((p.mass > 0).sum()) < 64
    assert float(p.mass.sum()) == pytest.approx(m0, rel=1e-6)
    mom = (p.mass[:, None] * p.vel).sum(0)
    np.testing.assert_allclose(mom.numpy(), p0.numpy(), atol=1e-5)
    _assert_close_worlds(w, j)


@pytest.mark.parametrize("backend,jax_backend", [
    ("torch", "jnp"), ("pm", "pm"), ("p3m", "p3m")])
def test_long_run_with_gravity(backend, jax_backend):
    """Merges on every backend against nbody_tpu, mass conserved, and gm
    tracking g·mass: each substep's force reads the gm and radius the last
    merge left (a stale gm would move the positions past the bound)."""
    cfg = dataclasses.replace(MERGE, pm_grid=64)
    jcfg = dataclasses.replace(MERGE_JAX, pm_grid=64)
    pos, mass, radius, vel = _cluster()
    w, j = _worlds(pos, mass, radius, vel, config=cfg, jconfig=jcfg)
    m0 = float(w.particles.mass.sum())
    w.update(1e-3, 40, backend=backend)
    j.update(1e-3, 40, backend=jax_backend)
    p = w.particles
    assert int((p.mass > 0).sum()) < 64
    assert float(p.mass.sum()) == pytest.approx(m0, rel=1e-5)
    assert torch.isfinite(p.pos).all() and torch.isfinite(p.vel).all()
    _assert_gm_tracks_mass(w)
    _assert_close_worlds(w, j)


@pytest.mark.parametrize("backend", ["torch", "pm", "p3m"])
def test_force_after_a_merge_reads_the_new_gm_and_radius(backend):
    """Two heavy bodies merge at the first substep, a tracer far away
    feels them: its acceleration at the second substep is the merged
    body's (g·8 at the center of mass), on every backend."""
    cfg = dataclasses.replace(MERGE, pm_grid=64)
    jcfg = dataclasses.replace(MERGE_JAX, pm_grid=64)
    pos = [[0.0, 0.0], [1.0, 0.0], [30.0, 0.0], [-25.0, 10.0]]
    w, j = _worlds(pos, mass=[5.0, 3.0, 0.0, 1.0], radius=[0.7, 0.7, 0.5, 2.0],
                   config=cfg, jconfig=jcfg)
    jb = {"torch": "jnp"}.get(backend, backend)
    w.update(DT, 1, backend=backend)
    j.update(DT, 1, backend=jb)
    acc1 = w.particles.acc.clone()
    w.update(DT, 1, backend=backend)
    j.update(DT, 1, backend=jb)
    assert float(w.particles.mass[1]) == 0.0
    acc2 = w.particles.acc.numpy()
    want = np.asarray(j.particles.acc)
    np.testing.assert_allclose(acc2, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # the merge moved the tracer's force (a stale gm would not)
    assert not torch.equal(torch.from_numpy(acc2[2]), acc1[2])


def test_tracers_never_merge():
    w, _ = _worlds([[0.0, 0.0], [0.3, 0.0], [0.6, 0.0]],
                   mass=[4.0, 0.0, 0.0], radius=[0.7, 0.5, 0.5])
    w.update(DT, 2, backend="torch")
    assert w.particles.mass.tolist() == [4.0, 0.0, 0.0]


def test_p3m_rejected_only_for_stale_bins():
    stale = dataclasses.replace(MERGE, p3m_rebin_interval=4)
    w, _ = _worlds([[0.0, 0.0], [50.0, 0.0]], mass=[5.0, 3.0],
                   radius=[0.7, 0.7], config=stale)
    with pytest.raises(ValueError, match="merge_collisions"):
        w.update(DT, 1, backend="p3m")
    with pytest.raises(ValueError, match="merge_collisions"):
        w.update_adaptive(0.01, backend="p3m")


def test_p3m_merging_matches_torch_at_rebin_1():
    cfg = dataclasses.replace(MERGE, pm_grid=64)

    def mk():
        return _worlds([[0.0, 0.0], [1.0, 0.0], [40.0, 40.0]],
                       mass=[5.0, 3.0, 2.0], radius=[0.7, 0.7, 0.5],
                       config=cfg)[0]

    wa, wb = mk(), mk()
    wa.update(DT, 3, backend="torch")
    wb.update(DT, 3, backend="p3m")
    pa, pb = wa.particles, wb.particles
    assert torch.equal(pa.mass, pb.mass) and pa.mass[:2].tolist() == [8.0, 0.0]
    _assert_gm_tracks_mass(wb)
    np.testing.assert_allclose(pb.pos.numpy(), pa.pos.numpy(), atol=2e-3)
    np.testing.assert_allclose(pb.vel.numpy(), pa.vel.numpy(), atol=2e-3)


def test_merge_factor_validation():
    with pytest.raises(ValueError, match="merge_factor"):
        dataclasses.replace(TINY, merge_factor=0.0)
    assert nt.SimConfig().merge_collisions is False
    assert nt.SimConfig().merge_factor == nb.SimConfig().merge_factor


def test_trajectory_capture_merges_too():
    from nbody_tpu_torch.trajectory import record_trajectory

    pos, mass, radius, vel = _cluster()
    a = _worlds(pos, mass, radius, vel)[0]
    b = _worlds(pos, mass, radius, vel)[0]
    traj = record_trajectory(a, 1e-3, frames=8, steps_per_frame=5,
                             backend="torch")
    b.update(1e-3, 40, backend="torch")
    assert traj.shape == (8, 64, 2)
    assert torch.equal(a.particles.mass, b.particles.mass)
    assert torch.equal(a.particles.pos, b.particles.pos)
    assert torch.equal(a.gm, b.gm)
    assert int((a.particles.mass > 0).sum()) < 64


def test_auto_resolution_is_merge_aware():
    from nbody_tpu_torch.world import AUTO_P3M_MIN_PAIRS, resolve_backend

    big = int(np.sqrt(AUTO_P3M_MIN_PAIRS)) * 2
    assert resolve_backend("auto", big, big) == "p3m"
    assert resolve_backend("auto", big, big, merging=True) == "p3m"
    assert resolve_backend("auto", big, big, merging=True,
                           rebin_interval=8) == "pm"
    assert resolve_backend("auto", 1000, 500, merging=True) == "torch"
    w = nt.create_world(nt.make_particles(np.zeros((3, 2), np.float32)),
                        config=dataclasses.replace(MERGE, p3m_rebin_interval=8),
                        device="cpu", default_backend="auto")
    assert w.default_backend == "torch"


def test_invariant_validator_understands_merged_worlds():
    w, _ = _worlds([[0.0, 0.0], [1.0, 0.0]], mass=[5.0, 3.0], radius=[0.7, 0.7])
    w.update(DT, 1, backend="torch")
    assert float(w.particles.mass[1]) == 0.0
    validate_world_invariants(w)
    plain, _ = _worlds([[0.0, 0.0], [50.0, 0.0]], mass=[5.0, 3.0],
                       radius=[0.7, 0.7], config=TINY)
    validate_world_invariants(plain)
    plain.state.mass[1] = 0.0          # a hole in a plain world's prefix
    plain._host_cache = None
    with pytest.raises(AssertionError, match="partition"):
        validate_world_invariants(plain)


# --- adaptive (tests/test_adaptive.py::test_composes_with_merging) --------

def test_adaptive_composes_with_merging():
    rng = np.random.default_rng(2)
    n = 48
    w, j = _worlds(rng.uniform(-2, 2, (n, 2)), rng.uniform(0.5, 2.0, n),
                   np.full(n, 0.35), rng.normal(0, 0.1, (n, 2)))
    m0 = float(w.particles.mass.sum())
    k = w.update_adaptive(0.05, dt_max=0.005, backend="torch")
    kj = j.update_adaptive(0.05, dt_max=0.005, backend="jnp")
    out = w.particles
    assert k == kj and k >= 10
    assert int((out.mass > 0).sum()) < n
    assert float(out.mass.sum()) == pytest.approx(m0, rel=1e-5)
    _assert_gm_tracks_mass(w)
    _assert_close_worlds(w, j)


def test_no_merge_in_the_dead_substeps_of_an_adaptive_run():
    """One live substep (t_span = dt_max), then seven dead ones of the
    batch: nbody_tpu's while-loop merges twice (the priming substep and the
    live one), and so must the port, though contacts remain."""
    n = 12                          # a chain: one merge a pass
    w, j = _worlds([[float(i), 0.0] for i in range(n)],
                   mass=np.arange(1, n + 1), radius=np.full(n, 0.6))
    k = w.update_adaptive(1e-3, dt_max=1e-3, backend="torch")
    assert k == j.update_adaptive(1e-3, dt_max=1e-3, backend="jnp") == 1
    np.testing.assert_array_equal(w.particles.mass.numpy(),
                                  np.asarray(j.particles.mass))
    _assert_gm_tracks_mass(w)
    st = w.state
    more = col.merge_pass(st.pos, st.vel, st.radius, st.mass, w.gm,
                          factor=1.0, g=10.0)[3]
    assert not torch.equal(more, st.mass)   # a third pass would merge more


def test_adaptive_merging_on_the_p3m_path_rebuilds_its_core_rows():
    cfg = dataclasses.replace(MERGE, pm_grid=64, p3m_exact_targets=4)
    jcfg = dataclasses.replace(MERGE_JAX, pm_grid=64, p3m_exact_targets=4)
    pos, mass, radius, vel = _cluster(n=48, spread=2.5)
    w, j = _worlds(pos, mass, radius, vel, config=cfg, jconfig=jcfg)
    k = w.update_adaptive(0.01, dt_max=0.005, backend="p3m")
    assert k == j.update_adaptive(0.01, dt_max=0.005, backend="p3m")
    _assert_close_worlds(w, j)


# --- sharded merging ------------------------------------------------------

def _sharded(pos, mass, radius, d=2, backend="torch", vel=None, config=MERGE):
    pos, vel, mass, radius = _arrays(pos, mass, radius, vel)
    return ShardedWorld(nt.make_particles(pos, vel=vel, mass=mass,
                                          radius=radius),
                        make_mesh(devices=["cpu"] * d), config=config,
                        force_backend=backend)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_two_body_merge(backend):
    sw = _sharded([[0.0, 0.0], [1.0, 0.0]], mass=[5.0, 3.0],
                  radius=[0.7, 0.7], backend=backend)
    sw.update(DT, 1)
    p = sw.particles
    assert p.mass.tolist() == [8.0, 0.0]
    assert float(p.pos[0, 0]) == pytest.approx(3.0 / 8.0, abs=1e-4)
    assert float(p.radius[0]) == pytest.approx((2 * 0.7**3) ** (1 / 3), rel=1e-5)
    validate_world_invariants(sw)


def _accreting(n=300, seed=8):
    """A dense cluster of n/2 massive bodies that merge, and n/2 tracers
    around it: (pos, mass, radius, vel) numpy arrays."""
    rng = np.random.default_rng(seed)
    k = n // 2
    pos = np.concatenate([rng.uniform(-4, 4, (k, 2)),
                          rng.uniform(-40, 40, (n - k, 2))])
    mass = np.concatenate([rng.uniform(0.5, 2.0, k), np.zeros(n - k)])
    radius = np.concatenate([np.full(k, 0.4), np.full(n - k, 0.5)])
    return pos, mass, radius, rng.normal(0, 0.2, (n, 2))


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_accretion_matches_single_device(backend):
    """20 substeps of a merging cluster on 4 CPU shards: the same merges in
    the same order as the World and as nbody_tpu's 4-device ShardedWorld
    (masses and gm_src equal), positions within the bound."""
    pos, mass, radius, vel = _accreting()
    w, _ = _worlds(pos, mass, radius, vel)
    w.update(0.01, 20, backend="torch")
    sw = _sharded(pos, mass, radius, d=4, backend=backend, vel=vel)
    sw.update(0.01, 20)
    a = _arrays(pos, mass, radius, vel)
    jw = jsh.ShardedWorld(nb.make_particles(a[0], vel=a[1], mass=a[2],
                                            radius=a[3]),
                          jsh.make_mesh(4), config=MERGE_JAX,
                          force_backend="jnp")
    jw.update(0.01, 20)
    for ref in (w.particles, jw.particles):
        np.testing.assert_array_equal(sw.particles.mass.numpy(),
                                      np.asarray(ref.mass))
        got, want = sw.particles.pos.numpy(), np.asarray(ref.pos)
        assert np.abs(got - want).max() / np.abs(want).max() < POS_TOL
    merged = int((w.particles.mass[:w.mass_len] == 0).sum())
    assert merged > 20, merged
    np.testing.assert_array_equal(sw.gm_src.numpy(), np.asarray(jw.gm_src))
    np.testing.assert_array_equal(sw.gm_src[:sw.mass_len].numpy(),
                                  w.gm.numpy())


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_ring"])
def test_sharded_force_after_a_merge_reads_the_new_gm(backend):
    """A merge zeroes a source of shard 0. The ring reads the shards' gm
    tensors that the merge updated in place (so its next gather carries
    the zero), and the next substep's force changes on every shard, as
    in the World."""
    rng = np.random.default_rng(4)
    n = 480                        # real targets on all 4 shards (t_loc 128)
    pos = rng.uniform(-60, 60, (n, 2))
    pos[0], pos[1] = (0.0, 0.0), (1.0, 0.0)
    mass = np.zeros(n)
    mass[:2] = (5.0, 3.0)
    mass[2:6] = 1.0
    radius = np.full(n, 0.5)
    radius[:2] = 0.7
    sw = _sharded(pos, mass, radius, d=4, backend=backend)
    w = _worlds(pos, mass, radius)[0]
    plain = _sharded(pos, mass, radius, d=4, backend=backend, config=TINY)
    gm_tensors = list(sw._gm_src)
    for x in (sw, w, plain):
        x.update(DT, 2)
    assert float(sw.particles.mass[1]) == 0.0
    assert all(a is b for a, b in zip(sw.ring.gm_src, gm_tensors))
    assert float(sw.ring.gm_src[0][1]) == 0.0
    assert float(sw.ring.gm_src[0][0]) == np.float32(10.0) * np.float32(8.0)
    got, want = sw.particles.acc.numpy(), w.particles.acc.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    moved = (sw.particles.acc - plain.particles.acc).abs().amax(dim=1) > 0
    t_loc = sw.t_loc
    for k in range(4):   # every shard's targets felt the merge
        lo, hi = k * t_loc, min((k + 1) * t_loc, n)
        assert moved[lo:hi].any(), k


def test_sharded_merge_record_and_adaptive():
    sw = _sharded([[0.0, 0.0], [1.0, 0.0], [10.0, 10.0]],
                  mass=[5.0, 3.0, 0.0], radius=[0.7, 0.7, 0.5], d=2)
    traj = sw.record(DT, frames=3, steps_per_frame=2)
    assert traj.shape == (3, 3, 2) and isinstance(traj, np.ndarray)
    assert float(sw.particles.mass[0]) == pytest.approx(8.0)
    sw2 = _sharded([[0.0, 0.0], [1.0, 0.0], [10.0, 10.0]],
                   mass=[5.0, 3.0, 0.0], radius=[0.7, 0.7, 0.5], d=2)
    n = sw2.update_adaptive(0.01, dt_max=5e-3)
    assert n >= 2
    assert float(sw2.particles.mass[0]) == pytest.approx(8.0)
    assert torch.isfinite(sw2.particles.pos).all()


def test_sharded_adaptive_merging_matches_the_world():
    pos, mass, radius, vel = _cluster(n=48, spread=2.5)
    sw = _sharded(pos, mass, radius, d=4, vel=vel)
    w = _worlds(pos, mass, radius, vel)[0]
    k = sw.update_adaptive(0.02, dt_max=0.005)
    assert k == w.update_adaptive(0.02, dt_max=0.005, backend="torch")
    np.testing.assert_array_equal(sw.particles.mass.numpy(),
                                  w.particles.mass.numpy())
    got, want = sw.particles.pos.numpy(), w.particles.pos.numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < POS_TOL
    validate_world_invariants(sw)


def test_sharded_merge_p3m_rejected():
    """"p3m" with merging is refused, as in nbody_tpu; "pm", which raised
    NotImplementedError before the sharded mesh solvers were ported,
    merges (tests/test_collisions.py:318's "pm" case)."""
    with pytest.raises(ValueError, match="not supported"):
        _sharded([[0.0, 0.0], [1.0, 0.0]], mass=[1.0, 1.0],
                 radius=[0.5, 0.5], backend="p3m")
    sw = _sharded([[0.0, 0.0], [1.0, 0.0]], mass=[5.0, 3.0],
                  radius=[0.7, 0.7], backend="pm")
    sw.update(DT, 1)
    p = sw.particles
    assert p.mass.tolist() == [8.0, 0.0]
    assert float(p.pos[0, 0]) == pytest.approx(3.0 / 8.0, abs=1e-4)
    assert float(p.radius[0]) == pytest.approx((2 * 0.7**3) ** (1 / 3), rel=1e-5)
    np.testing.assert_array_equal(sw.gm_src.numpy()[:2], [80.0, 0.0])
    validate_world_invariants(sw)
