"""The ablation path's plain versions (K5a, K5g, K5d, K5h, K5b's flavors,
and the flavors of K5e and K5c) against the TPU scripts' Pallas kernels in
scripts/ablations/, run in Pallas interpret mode on the CPU, on the same
numpy inputs: the two-galaxy scene, seed 11037, at N=2048, 4096 and 8192
(mass_len 1004, 2012 and 4070; S128 1024, 2048 and 4096). The K5b, K5e and
K5c scripts trace a full chunk even where the sources hold none, so their
chunks stay within S128.

The scripts are loaded from their files and are not edited; the test
patches ``pallas_call`` to interpret mode while it runs them. Tolerance:
max|Δ|/max|ref| < 5e-6, the direct force's bound; both sides are fp32 sums
of the same terms in another order (the scripts leave out the 1e-18
softening floor, which is absorbed in fp32 for radii >= 0.5).

The Newton kernel of tune_r2h.py is right only where the full massive
tiles fill whole source chunks (m_full % (fchunk // tile_t) == 0); it is
held to the port there, and the port's schedule is held to the direct sum
and to a pair count at every shape.
"""

import functools
import importlib.util
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

import nbody_tpu as nb
from nbody_tpu import forces as jforces
from nbody_tpu_torch.ablations import (_scene, tune_r2, tune_r2b, tune_r2c, tune_r2d,
                                       tune_direct, tune_p3m, tune_r2e,
                                       tune_r2f, tune_r2g, tune_r2h,
                                       tune_r4d_bcast_probe)
from nbody_tpu_torch.ops import bcast_probe as bp
from nbody_tpu_torch.ops import flavor_forces as ff
from nbody_tpu_torch.ops import newton_forces as nwf
from nbody_tpu_torch.ops import op_probe as op
from nbody_tpu_torch.ops import ptile_forces as ptf
from nbody_tpu_torch.ops import resident_forces as rsf
from nbody_tpu_torch.ops import stationary_forces as stf
from nbody_tpu_torch.ops import v2_forces as v2

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts" / "ablations"
TOL = 5e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_ablation_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels run in interpret mode while the test runs."""
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))


@functools.cache
def _scene_np(n):
    """The port's scene as numpy (pos, radius, gm (N,) zero past mass_len,
    mass_len), checked bit-equal to nbody_tpu's world of the same scene."""
    sc = _scene.make_scene(n, device="cpu")
    w = nb.create_world(nb.make_galaxies(n, 2, seed=_scene.SEED))
    pos, radius, gm = sc.pos.numpy(), sc.radius.numpy(), sc.gm.numpy()
    assert w.mass_len == sc.mass_len
    np.testing.assert_array_equal(pos, np.asarray(w.state.pos)[:n])
    np.testing.assert_array_equal(radius, np.asarray(w.state.radius)[:n])
    np.testing.assert_array_equal(gm, np.asarray(w.gm)[:n])
    return sc, pos, radius, gm, sc.mass_len


def _acc(ax, ay):
    return np.stack([np.asarray(ax)[0], np.asarray(ay)[0]], axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# --- the scene rows in the scripts' layouts ---

@pytest.mark.parametrize("n", [2048, 4096])
def test_scene_rows_match_the_scripts_layouts(n):
    sc, pos, radius, gm, m = _scene_np(n)
    s128 = -(-m // 128) * 128
    assert sc.s128 == s128
    np.testing.assert_array_equal(sc.src3(s128).numpy(), np.stack(
        [pos[:s128, 0], pos[:s128, 1], gm[:s128]]))
    np.testing.assert_array_equal(sc.tgt3().numpy(), np.stack(
        [pos[:, 0], pos[:, 1], radius]))
    np.testing.assert_array_equal(sc.tgt4().numpy(), np.stack(
        [pos[:, 0], pos[:, 1], radius, gm]))
    np.testing.assert_array_equal(sc.src4(s128).numpy(), np.stack(
        [pos[:s128, 0], pos[:s128, 1], gm[:s128], radius[:s128]]))
    # rows past N are inert padding: gm 0 (and radius 1)
    long = sc.src4(n + 5).numpy()
    np.testing.assert_array_equal(long[:, n:], [[0] * 5, [0] * 5, [0] * 5, [1] * 5])


# --- K5a: tune_r2.py::v2_acc ---

@pytest.mark.parametrize("tile_t,chunk", [(512, 2048), (1024, 512)])
@pytest.mark.parametrize("n", [2048, 4096])
def test_k5a_plain_matches_script(interpret, n, tile_t, chunk):
    sc, pos, radius, gm, m = _scene_np(n)
    src = sc.src3(sc.s128).numpy()
    want = np.asarray(_script("tune_r2").v2_acc(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(src),
        tile_t=tile_t, chunk=chunk))
    got = rsf.v2_acc(_t(pos), _t(radius), _t(src), block=tile_t,
                     chunk=chunk)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("tile,chunk,s,want", [
    (128, 512, 1024, (1, 128, 512)), (256, 2048, 1024, (2, 128, 1024)),
    (512, 4096, 4096, (2, 256, 4096)), (1024, 1024, 1003, (2, 512, 1008)),
    (64, 8, 0, (1, 64, 8))])
def test_k5a_maps_block_to_v2_shape(monkeypatch, tile, chunk, s, want, precise):
    """K5a's wrapper launches ``v2_forces.cu`` in the column layout, its
    rsqrt or precise variant, at ``v2_forces.shape(block)`` (the script's
    tile_t as P targets a thread), the chunk cut to S rounded up to 8 (the
    script's ``min(chunk, S)``: one chunk), the split left to the plan, and
    counts the launch as K5a's alone. The card is stood in for by a spy on
    the launch."""
    calls = []
    monkeypatch.setattr(rsf, "_device_of", lambda t: torch.device("cuda"))
    monkeypatch.setattr(rsf, "_check", lambda *a: None)
    monkeypatch.setattr(v2, "_launch", lambda *a: calls.append(a) or "acc")
    pos, radius = torch.zeros((300, 2)), torch.ones(300)
    before = (rsf.LAUNCHES, v2.LAUNCHES)
    assert rsf.v2_acc(pos, radius, torch.zeros((3, s)), block=tile,
                      chunk=chunk, precise=precise) == "acc"
    (_, src, t, rows, variant, p, threads, ch, n_split, _),  = calls
    assert (t, rows, n_split, src.shape) == (300, False, None, (3, s))
    assert (p, threads, ch) == want and (p, threads) == v2.shape(tile)
    assert variant == v2.K5A[precise] and variant not in v2.FLAVORS.values()
    assert (rsf.LAUNCHES, v2.LAUNCHES) == (before[0] + 1, before[1])


# --- K5g: tune_r2g.py::make_ptile ---

@pytest.mark.parametrize("p,sub_t,chunk", [(4, 256, 512), (2, 512, 1024)])
@pytest.mark.parametrize("n", [2048, 4096])
def test_k5g_plain_matches_script(interpret, n, p, sub_t, chunk):
    sc, *_ = _scene_np(n)
    tgt, src = sc.tgt3().numpy(), sc.src3(sc.s128).numpy()
    want = _acc(*_script("tune_r2g").make_ptile(p, sub_t, chunk)(
        jnp.asarray(tgt), jnp.asarray(src)))
    got = _acc(*ptf.ptile_acc(_t(tgt), _t(src), p=p, block=sub_t // 2,
                              chunk=chunk))
    assert rel_err(got, want) < TOL


# --- K5d: tune_r2d.py::make_k3 ---

@pytest.mark.parametrize("tile_t,chunk,manual", [(512, 256, False),
                                                 (256, 512, True)])
@pytest.mark.parametrize("n", [2048, 4096])
def test_k5d_plain_matches_script(interpret, n, tile_t, chunk, manual):
    """The plain version sums per-chunk partials in chunk order; the
    script revisits one accumulator chunk by chunk."""
    sc, *_ = _scene_np(n)
    s_pad = -(-sc.mass_len // chunk) * chunk
    tgt, src = sc.tgt3().numpy(), sc.src3(s_pad).numpy()
    want = np.asarray(_script("tune_r2d").make_k3(tile_t, chunk, manual)(
        jnp.asarray(tgt), jnp.asarray(src)))
    got = stf.stationary_acc(_t(tgt), _t(src), block=tile_t // 2, chunk=chunk)
    assert got.shape == (2, n)
    assert rel_err(got, want) < TOL


def test_k5d_plain_is_the_chunk_ordered_sum():
    sc, *_ = _scene_np(2048)
    tgt, src = sc.tgt3(), sc.src3(1024)
    want = torch.zeros((2, 2048))
    for lo in (0, 256, 512, 768):
        want += stf.stationary_acc_plain(tgt, src[:, lo:lo + 256], chunk=256)
    assert torch.equal(stf.stationary_acc_plain(tgt, src, chunk=256), want)


# --- K5h: tune_r2h.py::make_newton ---

# (n, tile_t, fchunk) where the script's kernel is right: the full massive
# tiles fill whole chunks (m_full = 7 at N=2048 with tile 128 and 3 with
# tile 256; 15 and 7 at N=4096).
NEWTON_EXACT = [(2048, 128, 128), (2048, 256, 256), (4096, 128, 384),
                (4096, 256, 256)]


@pytest.mark.parametrize("n,tile_t,fchunk", NEWTON_EXACT)
def test_k5h_plain_matches_script(interpret, n, tile_t, fchunk):
    sc, *_ = _scene_np(n)
    m_full = sc.mass_len // tile_t
    assert m_full % (fchunk // tile_t) == 0
    tgt, src = sc.tgt4().numpy(), sc.src4(sc.s128).numpy()
    want = _acc(*_script("tune_r2h").make_newton(
        tile_t, sc.mass_len, sc.s128, fchunk)(jnp.asarray(tgt), jnp.asarray(src)))
    got = _acc(*nwf.newton_acc(_t(tgt), _t(src), sc.mass_len, tile=tile_t))
    assert rel_err(got, want) < TOL


def test_k5h_script_miscounts_where_tiles_do_not_fill_chunks(interpret):
    """The TPU reference's fault: at N=2048, tile 256, fchunk 512 (m_full
    = 3, two tiles per chunk) the massive tile past the full chunks sums
    its chunk twice and misses the sources below it. The port's schedule
    has no chunks and is right there."""
    sc, pos, radius, gm, m = _scene_np(2048)
    tgt, src = sc.tgt4().numpy(), sc.src4(sc.s128).numpy()
    ref = np.asarray(jforces.direct_sum_acc(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(pos[:m]),
        jnp.asarray(gm[:m]), precise=False))
    bad = _acc(*_script("tune_r2h").make_newton(256, m, sc.s128, 512)(
        jnp.asarray(tgt), jnp.asarray(src)))
    assert rel_err(bad, ref) > 0.5
    got = _acc(*nwf.newton_acc(_t(tgt), _t(src), m, tile=256))
    assert rel_err(got, ref) < TOL


@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("n", [2048, 2000, 3001])
def test_k5h_plain_matches_direct_sum(n, tile):
    """Every tile width at N and mass_len that are not whole numbers of
    tiles, against nbody_tpu's direct sum."""
    sc, pos, radius, gm, m = _scene_np(n)
    want = np.asarray(jforces.direct_sum_acc(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(pos[:m]),
        jnp.asarray(gm[:m]), precise=False))
    got = _acc(*nwf.newton_acc(sc.tgt4(), sc.src4(sc.s128), m, tile=tile))
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("t,m,s,w", [
    (2048, 1004, 1024, 128),     # the N=2048 scene
    (2000, 997, 1024, 256),      # ragged N and mass_len
    (4096, 2012, 2048, 512),
    (1000, 1000, 1000, 128),     # all massive, S = M
    (700, 0, 128, 128),          # no massive rows
    (130, 129, 256, 128),        # one full massive tile
    (5000, 2500, 2560, 256),
    (1536, 1536, 1536, 256),     # whole tiles, an even m_full
])
def test_newton_schedule_counts_every_pair_once(t, m, s, w):
    """Every (target, source) pair of T x S is counted once by the blocks
    of the schedule: forward ranges once, a dual block once for its
    targets and once, reversed, for its sources; every tile is run by
    exactly one block, the pairs of massive tiles first."""
    count = np.zeros((t, s), np.int32)
    tiles = []
    blocks = nwf.newton_schedule(t, m, s, w)
    for block in blocks:
        for i, work in block:
            tiles.append(i)
            rows = slice(i * w, min((i + 1) * w, t))
            for kind, lo, hi in work:
                count[rows, lo:hi] += 1
                if kind == "dual":
                    count[lo:hi, rows] += 1
    assert sorted(tiles) == list(range(-(-t // w)))
    assert (count == 1).all(), np.argwhere(count != 1)[:5]
    fwd, dual = nwf.newton_pairs(t, m, s, w)
    assert fwd + 2 * dual == t * s
    assert dual == sum(w * (hi - lo) for block in blocks for _, work in block
                       for kind, lo, hi in work if kind == "dual")


# --- K5b: tune_r2b.py::make_v2 (kernel_cols, kernel_rows) ---

# (script flavor, unroll) -> the port's flavor; "rows" is the row layout
K5B = {("base", 1): "base", ("base", 2): "unroll2", ("partial", 1): "partial",
       ("static", 1): "static", ("rows", 1): "rows", ("rows", 2): "unroll2"}


@pytest.mark.parametrize("flavor,unroll", list(K5B))
@pytest.mark.parametrize("n", [4096, 8192])
def test_k5b_plain_matches_script(interpret, n, flavor, unroll):
    """Tile 512 (P = 2 at block 256), chunk 1024, through ``v2_forces``.
    Bound 5e-6 (TOL)."""
    sc, pos, radius, gm, m = _scene_np(n)
    src = sc.src3(sc.s128)
    want = np.asarray(_script("tune_r2b").make_v2(flavor, 512, 1024, unroll)(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(src.numpy())))
    tgt = sc.tgt3() if flavor == "rows" else (sc.pos, sc.radius)
    p, block = v2.shape(512)
    got = ff.as_acc(v2.v2_acc(tgt, src, flavor=K5B[flavor, unroll], p=p,
                              block=block, chunk=1024))
    assert got.shape == (n, 2)
    assert rel_err(got, want) < TOL


def test_v2_plain_follows_the_kernels_sums():
    """K5b's plain version, term by term on a small case (3 targets, 40
    sources, chunks of 16): each chunk's terms summed, the sums added in
    chunk order; partial: chain c of a chunk (sources c, c + 8, ...)
    added to lane c across chunks, the lanes folded in order. Both layouts
    give the same bits."""
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(np.stack([rng.normal(size=3), rng.normal(size=3),
                                     rng.uniform(1, 2, 3)]).astype(np.float32))
    src = torch.from_numpy(np.stack([rng.normal(size=40), rng.normal(size=40),
                                     rng.uniform(1, 9, 40)]).astype(np.float32))
    dx = src[0][None] - tgt[0][:, None]
    dy = src[1][None] - tgt[1][:, None]
    inv = torch.rsqrt(dx * dx + dy * dy + (tgt[2] + 1e-18)[:, None])
    f = src[2][None] * (inv * inv * inv)
    fold = ff._fold
    for e, got_row in zip((dx * f, dy * f), range(2)):
        base = fold([e[:, a:a + 16].sum(1) for a in (0, 16, 32)])
        lanes = fold([torch.stack([e[:, a + c:a + 16:8].sum(1)
                                   for c in range(8)], 1)
                      for a in (0, 16, 32)])
        partial = fold(list(lanes.unbind(1)))
        for flavor, want in (("base", base), ("static", base),
                             ("partial", partial)):
            rows = v2.v2_acc_plain(tgt, src, flavor=flavor, chunk=16)
            cols = v2.v2_acc_plain((tgt[:2].T.contiguous(), tgt[2]), src,
                                   flavor=flavor, chunk=16)
            assert torch.equal(rows[got_row][0], want)
            assert torch.equal(cols[:, got_row], want)


@pytest.mark.parametrize("flavor,rows", [
    *((f, True) for f in ("base", "rows", "unroll2", "static", "partial")),
    ("control", False)])
def test_flavor_forces_refuses_k5b(flavor, rows):
    """K5b's flavors and its column layout moved to ``v2_forces``."""
    sc, *_ = _scene_np(2048)
    tgt = sc.tgt3() if rows else (sc.pos, sc.radius)
    with pytest.raises(ValueError):
        ff.flavor_acc(tgt, sc.src3(sc.s128), flavor=flavor)


# --- K5e: tune_r2e.py::make_v3 ---

@pytest.mark.parametrize("flavor", ["control", "partial_jnp", "fma_kloop",
                                    "f_assoc"])
@pytest.mark.parametrize("n,tile_t,chunk", [(4096, 1024, 1024),
                                            (8192, 2048, 2048)])
def test_k5e_plain_matches_script(interpret, n, tile_t, chunk, flavor):
    """Tile 1024 and 2048 (P = 2 and 4 at block 512, K = 8 and 4 chains).
    Bound 5e-6 (TOL)."""
    sc, *_ = _scene_np(n)
    tgt, src = sc.tgt3(), sc.src3(sc.s128)
    want = _acc(*_script("tune_r2e").make_v3(flavor, tile_t, chunk)(
        jnp.asarray(tgt.numpy()), jnp.asarray(src.numpy())))
    p, block = ff.shape(tile_t)
    got = _acc(*ff.flavor_acc(tgt, src, flavor=flavor, p=p, block=block,
                              chunk=chunk))
    assert rel_err(got, want) < TOL


# --- K5c: tune_r2c.py::make_probe ---

@pytest.mark.parametrize("flavor", tune_r2c.FLAVORS_C)
@pytest.mark.parametrize("n", [4096, 8192])
def test_k5c_plain_matches_script(interpret, n, flavor):
    """The script's TILE_T 512 and CHUNK 2048; the probes are wrong physics
    on both sides alike (skeleton and one_axis leave ay at 0, no_reduce
    adds the first source of each chunk, and the gm = 0 rows that pad the
    sources to S128 count where gm is dropped). Bound 5e-6 (TOL): no flavor's sums cancel
    enough at these N to need more (measured at most 5.3e-7)."""
    sc, *_ = _scene_np(n)
    tgt, src = sc.tgt3(), sc.src3(sc.s128)
    want = _acc(*_script("tune_r2c").make_probe(flavor)(
        jnp.asarray(tgt.numpy()), jnp.asarray(src.numpy())))
    got = _acc(*ff.flavor_acc(tgt, src, flavor=flavor, p=1,
                              block=tune_r2c.TILE_T, chunk=tune_r2c.CHUNK))
    if flavor in ("skeleton", "one_axis"):
        assert not got[:, 1].any() and not want[:, 1].any()
    assert rel_err(got, want) < TOL


def test_flavor_plain_follows_the_kernels_sums():
    """The plain versions' association, term by term on a small case: per
    chunk, K chains by source index, lane sums across chunks."""
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    fold = ff._fold
    chunk = [e[:, a:a + 16].sum(1) for a in (0, 16, 32)]
    assert torch.equal(ff._reduce(e, "chunk", 16, 1), fold(chunk))
    assert torch.equal(ff._reduce(e, "first", 16, 1), fold([e[:, 0], e[:, 16], e[:, 32]]))
    lanes = fold([torch.stack([e[:, a + c:a + 16:4].sum(1) for c in range(4)], 1)
                  for a in (0, 16, 32)])
    assert torch.equal(ff._reduce(e, "lanes", 16, 4), fold(list(lanes.unbind(1))))
    runs = [fold([e[:, a + c:a + 16:2].sum(1) for c in range(2)]) for a in (0, 16, 32)]
    assert torch.equal(ff._reduce(e, "chains", 16, 2), fold(runs))


# --- wrappers on the CPU ---

def test_cpu_wrappers_make_no_launch():
    sc, *_ = _scene_np(2048)
    counters = (rsf, ptf, stf, nwf, ff, v2, op, bp)
    before = tuple(c.LAUNCHES for c in counters)
    rsf.v2_acc(sc.pos, sc.radius, sc.src3(sc.s128))
    ptf.ptile_acc(sc.tgt3(), sc.src3(sc.s128))
    stf.stationary_acc(sc.tgt3(), sc.src3(1024), chunk=512)
    nwf.newton_acc(sc.tgt4(), sc.src4(sc.s128), sc.mass_len)
    ff.flavor_acc(sc.tgt3(), sc.src3(sc.s128), flavor="fma_kloop", p=4)
    v2.v2_acc((sc.pos, sc.radius), sc.src3(sc.s128), flavor="partial")
    v2.v2_acc(sc.tgt3(), sc.src3(sc.s128), flavor="static", p=1, block=512)
    op.op_probe(sc.pos, sc.pos, expr="rsqrt", loops=3)
    bp.bcast_acc(sc.tgt3(), sc.src3(1024), reps=2)
    assert tuple(c.LAUNCHES for c in counters) == before


@pytest.mark.parametrize("call,exc", [
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128)[:2]), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos.double(), sc.radius, sc.src3(128)), TypeError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128), block=100), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128), block=300), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128), block=2048), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128), chunk=0), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128), chunk=12), ValueError),
    (lambda sc: rsf.v2_acc(sc.pos, sc.radius, sc.src3(128),
                           chunk=v2.MAX_CHUNK + 8), ValueError),
    (lambda sc: ptf.ptile_acc(sc.tgt3(), sc.src3(128), p=3), ValueError),
    (lambda sc: ptf.ptile_acc(sc.tgt3().T, sc.src3(128)), ValueError),
    (lambda sc: stf.stationary_acc(sc.tgt3(), sc.src3(1000), chunk=512), ValueError),
    (lambda sc: nwf.newton_acc(sc.tgt4(), sc.src4(1024), 1004, tile=64), ValueError),
    (lambda sc: nwf.newton_acc(sc.tgt4(), sc.src4(512), 1004), ValueError),
    (lambda sc: nwf.newton_acc(sc.tgt3(), sc.src4(1024), 1004), ValueError),
    (lambda sc: ff.flavor_acc(sc.tgt3(), sc.src3(128), flavor="nope"), ValueError),
    (lambda sc: ff.flavor_acc(sc.tgt3(), sc.src3(128), flavor="skeleton", p=2), ValueError),
    (lambda sc: ff.flavor_acc((sc.pos, sc.radius), sc.src3(128), flavor="f_assoc"), ValueError),
    (lambda sc: ff.flavor_acc(sc.tgt3(), sc.src3(128), block=1024), ValueError),
    (lambda sc: ff.flavor_acc(sc.tgt3(), sc.src3(128), chunk=100), ValueError),
    (lambda sc: ff.flavor_acc(sc.tgt3().double(), sc.src3(128)), TypeError),
    (lambda sc: v2.v2_acc(sc.tgt3(), sc.src3(128), flavor="control"), ValueError),
    (lambda sc: v2.v2_acc(sc.tgt3(), sc.src3(128), p=4), ValueError),
    (lambda sc: v2.v2_acc(sc.tgt3(), sc.src3(128), block=1024), ValueError),
    (lambda sc: v2.v2_acc(sc.tgt3(), sc.src3(128), chunk=v2.MAX_CHUNK + 8), ValueError),
    (lambda sc: v2.v2_acc((sc.pos, sc.radius[:5]), sc.src3(128)), ValueError),
    (lambda sc: op.op_probe(sc.pos, sc.radius, expr="add", loops=3), ValueError),
    (lambda sc: op.op_probe(sc.pos, sc.pos, expr="exp", loops=3), ValueError),
    (lambda sc: op.op_probe(sc.pos, sc.pos, expr="add", loops=-1), ValueError),
    (lambda sc: bp.bcast_acc(sc.tgt3(), sc.src3(1000)), ValueError),
    (lambda sc: bp.bcast_acc(sc.tgt3(), sc.src3(8192)), ValueError),
    (lambda sc: bp.bcast_acc(sc.tgt3(), sc.src3(1024), variant="tex"), ValueError),
])
def test_wrapper_argument_errors(call, exc):
    sc, *_ = _scene_np(2048)
    with pytest.raises(exc):
        call(sc)


@pytest.mark.parametrize("module", [tune_r2, tune_r2g, tune_r2d, tune_r2h,
                                    tune_r2b, tune_r2e, tune_r2c, tune_r2f,
                                    tune_r4d_bcast_probe, tune_direct])
def test_ablation_module_needs_the_card(module, monkeypatch):
    """Each module's entry point measures the card; without one it raises
    before building a scene or drawing inputs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_scene, "make_scene", pytest.fail)
    monkeypatch.setattr(module, "run", pytest.fail)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main()


@pytest.mark.parametrize("what", ["fused", "hop"])
@pytest.mark.parametrize("precise", [False, True])
def test_parent_side_jobs_run_the_public_wrappers(what, precise):
    """``tune_direct parent`` drives each commit through its public
    wrappers (``ablations/_side.py``); on CPU tensors they take their plain
    versions, and a job's outputs are the fused substep's."""
    from nbody_tpu_torch.ablations import _side
    from nbody_tpu_torch.ops import direct_forces as df

    job = {"what": what, "n": 300, "precise": precise, "plan": None}
    times, out = _side.run_job(job, torch.device("cpu"), {})
    assert times == {"ms": None}
    pos, vel, radius, gm = _side.world_state(300, "cpu")
    want = df.fused_substep_plain(1.0, pos, vel, radius, gm, precise=precise)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def test_parent_compares_each_old_job_with_unsplit_new_ones():
    """Every bit comparison of ``tune_direct parent`` holds this tree at
    n_split = 1 (the parent's bits are defined there) against the other
    commit's job with the same shape and no plan."""
    assert len(tune_direct.BIT_JOBS) == 6
    for _, old, new in tune_direct.BIT_JOBS:
        assert old["plan"] is None and new
        for job in new:
            assert job["plan"][1] == 1
            assert {k: v for k, v in job.items() if k != "plan"} == \
                {k: v for k, v in old.items() if k != "plan"}


def test_tune_p3m_needs_the_card(monkeypatch):
    """``tune_p3m parent`` measures the card; without one it raises before
    it starts a side."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tune_p3m, "parent", pytest.fail)
    with pytest.raises(RuntimeError, match="CUDA"):
        tune_p3m.main(["parent", "elsewhere"])


@pytest.mark.parametrize("route", ["cells", "blocks"])
def test_parent_side_pp_job_gives_rows_in_cell_order(route, monkeypatch):
    """``tune_p3m parent``'s K4 job: a tree with ``pp_cells`` calls it, a
    tree without (the parent) calls ``pp_blocks`` with the counts on blocks
    packed here from the same bins. Either way the job's output is one
    (x, y) a target in cell order, 0 past its cell's cap: the plain
    version's rows. Bound 1e-6 of max|ref|, not bit equality: PyTorch's
    CPU taper may round a process's first call differently (see
    test_torch_p3m.py::test_pp_cells_overflow_rows_are_zero)."""
    from nbody_tpu_torch.ablations import _side
    from nbody_tpu_torch.ops import p3m_forces, p3m_pp

    n, grid, cap = 2000, 128, 8
    w = _side.p3m_world(n, grid, cap, "cpu")
    st, s = w.state, w.mass_len
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], w.gm,
                               grid=grid, rc_cells=4, exact_targets=0)
    trows = p3m_forces._cell_rows(st.pos, st.radius + p3m_pp.SOFTENING_FLOOR,
                                  bins["order_t"])
    srows = p3m_forces._cell_rows(st.pos[:s], w.gm, bins["order_s"])
    want = p3m_pp.pp_cells_plain(
        trows, srows, bins["start_t"], bins["counts_t"], bins["start_s"],
        bins["counts_s"], 4 * bins["h"], 4.0, cap_t=cap, cap_s=cap)
    if route == "blocks":
        monkeypatch.delattr(p3m_pp, "pp_cells")
    job = {"what": "pp", "n": n, "grid": grid, "cap": cap, "precise": False}
    times, (got,) = _side.run_job(job, torch.device("cpu"), {})
    assert times == {"ms": None}
    zero = want == 0
    assert zero.all(1).any() and torch.equal(got[zero], want[zero])
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize("module", [tune_r2b, tune_r2e])
def test_flavor_sweeps_are_launchable(module):
    """Every configuration of K5b's sweep passes ``v2_forces``' checks, and
    of K5e's the flavor wrapper's, with tile_t = P * block; K5b runs two
    targets a thread at every tile of its sweep (256 and up)."""
    for cfg in module.SWEEP:
        if module is tune_r2b:
            _, flavor, _, tile_t, chunk = cfg
            p, block = v2.shape(tile_t)
            assert p == 2
            v2._check_v2(flavor, p, block, chunk)
        else:
            flavor, tile_t, chunk = cfg
            p, block = ff.shape(tile_t)
            ff._check_flavor(flavor, p, block, chunk)
        assert p * block == tile_t


@pytest.mark.parametrize("rows", [False, True])
def test_parent_side_v2_job_runs_the_v2_wrapper(rows):
    """``tune_r2b parent``'s job drives ``v2_forces.v2_acc`` in a tree that
    has it; on CPU tensors that is the plain version, in (N, 2) form."""
    from nbody_tpu_torch.ablations import _side

    job = {"what": "v2", "n": 2048, "flavor": "partial", "rows": rows,
           "tile_t": 512, "chunk": 1024}
    times, (got,) = _side.run_job(job, torch.device("cpu"), {})
    assert times == {"ms": None, "p": 2}
    sc, *_ = _scene_np(2048)
    tgt = sc.tgt3() if rows else (sc.pos, sc.radius)
    want = ff.as_acc(v2.v2_acc_plain(tgt, sc.src3(sc.s128), flavor="partial",
                                     chunk=1024))
    assert torch.equal(got, want)
    assert [j["what"] for j in tune_r2b.jobs()] == ["v2"] * len(tune_r2b.SWEEP)


@pytest.mark.parametrize("job", [
    {"what": "k5a", "n": 2048, "block": 512, "chunk": 1024, "precise": False},
    {"what": "k5a", "n": 2048, "block": 256, "chunk": 512, "precise": True},
    {"what": "k5i", "variant": "ldg", "abs_row2": False},
    {"what": "k5i", "variant": "smem", "abs_row2": True, "n_split": 3}])
def test_parent_side_k5_jobs_run_the_public_wrappers(job):
    """``tune_r2 parent``'s and ``tune_r4d_bcast_probe parent``'s jobs drive
    ``resident_forces.v2_acc`` and ``bcast_probe.bcast_acc``; on CPU
    tensors those are the plain versions (one split where none is
    given)."""
    from nbody_tpu_torch.ablations import _side

    times, (got,) = _side.run_job(job, torch.device("cpu"), {})
    if job["what"] == "k5a":
        assert times == {"ms": None}
        sc, *_ = _scene_np(2048)
        want = rsf.v2_acc_plain(sc.pos, sc.radius, sc.src3(sc.s128),
                                precise=job["precise"])
    else:
        split = job.get("n_split", 1)
        assert times == {"ms": None, "plan": 1, "n_split": split}
        tgt, src = tune_r4d_bcast_probe.inputs("cpu", job["abs_row2"])
        want = bp.bcast_acc_plain(tgt, src, reps=tune_r4d_bcast_probe.REPS,
                                  n_split=split)
    assert _scene.bit_equal(got, want)


def test_k5_parent_jobs_cover_both_sweeps():
    """``tune_r2 parent`` runs each side's tiles on both paths, this tree
    also the parent's; ``tune_r4d_bcast_probe parent`` every variant on
    both input sets."""
    old, new = tune_r2.jobs(tune_r2.PARENT_TILES), tune_r2.jobs(tune_r2.TILES)
    assert len(old) == len(new) == 2 * 12
    for jobs in (old, new):
        assert {(j["block"], j["chunk"]) for j in jobs if j["precise"]} == \
            {(j["block"], j["chunk"]) for j in jobs if not j["precise"]}
    assert {(j["block"], j["chunk"]) for j in new} == set(tune_r2.SWEEP)
    k5i = tune_r4d_bcast_probe.jobs(7, reps=None)
    assert {(j["variant"], j["abs_row2"]) for j in k5i} == {
        (v, a) for v in bp.VARIANTS for a in (False, True)}
    assert all(j["n_split"] == 7 and j["reps"] is None for j in k5i)


@pytest.mark.parametrize("module", [tune_r2, tune_r2g, tune_r2d, tune_r2h])
def test_ablation_sweeps_are_launchable(module):
    """Every configuration of a module's sweep passes its wrapper's checks
    (block, chunk and tile ranges) on a small CPU scene."""
    sc, *_ = _scene_np(2048)
    for cfg in module.SWEEP:
        if module is tune_r2:
            p, threads = rsf.shape(*cfg)
            assert p == 2 and p * threads == cfg[0]
        elif module is tune_r2g:
            p, block, chunk, _ = cfg
            assert p in ptf.PS
            rsf._check_launch(block, chunk)
        elif module is tune_r2d:
            rsf._check_launch(*cfg[:2])
        else:
            assert cfg in nwf.TILES
