"""The plain references against the program's own plain versions, on the
CPU at small sizes: the same semantics, to float32 rounding."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import scene
from perfbench.reference import common, direct, p3m


def small_world(n: int, seed: int, **sim):
    import nbody_tpu_torch as nbt

    sc = scene.make_galaxies(n, 2, scene.rng_of(seed))
    w = nbt.create_world(nbt.make_particles(sc["pos"], vel=sc["vel"],
                                            mass=sc["mass"], radius=sc["radius"]),
                         config=nbt.SimConfig(**sim), device="cpu")
    return sc, w


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def test_partition_is_the_worlds_start():
    sc, w = small_world(1500, 4)
    ref = common.partition(sc, "cpu")
    for f in ("pos", "vel", "acc", "mass", "radius"):
        assert torch.equal(ref[f], getattr(w.state, f)), f
    assert torch.equal(ref["gm"], w.gm) and ref["mass_len"] == w.mass_len


def test_direct_reference_is_the_direct_sum():
    from nbody_tpu_torch import forces

    sc, w = small_world(1200, 9)
    st = w.state
    want = forces.direct_sum_acc(st.pos.double(), st.radius.double(),
                                 st.pos[:w.mass_len].double(), w.gm.double())
    got = direct.acc(st.pos, st.radius, w.gm, {})
    assert rel(got, want) < 1e-12


def test_p3m_cells_are_the_programs_bins():
    from nbody_tpu_torch.ops import p3m_forces

    sc, w = small_world(3000, 5)
    st, s = w.state, w.mass_len
    bins = p3m_forces.p3m_bins(st.pos, st.radius, st.pos[:s], w.gm, grid=128,
                               rc_cells=4, exact_targets=8)
    lo, h = p3m.box(st.pos, 128)
    assert torch.equal(lo, bins["lo"]) and torch.equal(h, bins["h"])
    cid, gc = p3m.cells(st.pos, lo, h, 128, 4)
    order_t, start_t, _, _ = p3m.kept(cid, gc, 10**9)
    order_s, start_s, _, _ = p3m.kept(cid[:s], gc, 10**9, priority=w.gm)
    assert torch.equal(order_t, bins["order_t"]) and torch.equal(order_s, bins["order_s"])
    assert torch.equal(start_t.int(), bins["start_t"])
    assert torch.equal(start_s.int(), bins["start_s"])


def test_p3m_reference_is_the_programs_p3m():
    import nbody_tpu_torch as nbt

    sim = {"pm_grid": 128, "p3m_cell_capacity": 24, "p3m_rc_cells": 4,
           "p3m_exact_targets": 16, "pm_softening": 2.0}
    sc, w = small_world(3000, 6)
    st = w.state
    want = nbt.p3m_acc(st.pos, st.radius, st.pos[:w.mass_len], w.gm, 2.0,
                       grid=128, rc_cells=4, cell_capacity=24, exact_targets=16)
    got = p3m.acc(st.pos, st.radius, w.gm, {"sim": sim})
    assert rel(got, want) < 2e-5
    # full cells and the exact rows are in play at this size
    cid, gc = p3m.cells(st.pos, *p3m.box(st.pos, 128), 128, 4)
    assert int(torch.bincount(cid).max()) > 24


def test_pair_blocks_split_every_pair_once(monkeypatch):
    sc, w = small_world(2000, 8)
    st = w.state
    lo, h = p3m.box(st.pos, 64)
    cid, gc = p3m.cells(st.pos, lo, h, 64, 4)
    whole = p3m.pair_blocks(st.pos, cid, cid[:w.mass_len], w.gm, gc, 40)
    monkeypatch.setattr(p3m, "PAIR_CHUNK", 5000)
    split = p3m.pair_blocks(st.pos, cid, cid[:w.mass_len], w.gm, gc, 40)
    assert len(split[-1]) > 2
    pairs = [torch.stack(p3m.candidates(*split[1:5], gc, a, b), 1)
             for a, b in split[-1]]
    allp = torch.stack(p3m.candidates(*whole[1:5], gc, *whole[-1][0]), 1)
    assert torch.equal(torch.cat(pairs), allp)


def test_euler_is_the_programs_step():
    from nbody_tpu_torch.ops import direct_forces

    sc, w = small_world(800, 3)
    st = w.state
    npos, nvel, acc = direct_forces.fused_substep_plain(
        0.01, st.pos, st.vel, st.radius, w.gm)
    x, v = common.euler(st.pos, st.vel, acc, 0.01, torch.float32)
    assert torch.equal(v, nvel) and torch.equal(x, npos)
    assert np.float32(0.01) == common.dt32(0.01)
