"""The comparison that decides ``correct``: a sound run passes; the timed
path broken underneath fails, once for each fault a cell can have; and
the control, the reference in bfloat16 in the program's place, fails. On
the CPU at small sizes, with the kernels' plain versions."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness, judge
from perfbench.tests.conftest import small_cell

CELLS = ["direct-65k.run", "p3m-1m.run"]


def run(cell, seed: int = 31):
    return harness.run(cell, seed, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("work", CELLS)
def test_sound_run_is_correct(work, cpu_cuda_backend):
    out = run(small_cell(work))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0


def unchanged(world_mod, monkeypatch):
    """A step that returns its state unchanged."""
    monkeypatch.setattr(world_mod, "update_state",
                        lambda state, gm, dt, n, **kw: state)


def half_batch(world_mod, monkeypatch):
    """Half of the massive rows left out of the force, the mean taken over
    the rest (their gm doubled)."""
    real = world_mod.update_state

    def half(state, gm, dt, n, **kw):
        keep = gm.shape[0] // 2
        return real(state, torch.cat([2 * gm[:keep], 0 * gm[keep:]]), dt, n, **kw)
    monkeypatch.setattr(world_mod, "update_state", half)


def altered(world_mod, monkeypatch):
    """One answer altered where it is produced: a row's velocity."""
    real = world_mod.update_state

    def alter(state, gm, dt, n, **kw):
        out = real(state, gm, dt, n, **kw)
        out.vel[7] += 1.0
        return out
    monkeypatch.setattr(world_mod, "update_state", alter)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("work", CELLS)
def test_broken_timed_path_is_not_correct(work, fault, cpu_cuda_backend, monkeypatch):
    import nbody_tpu_torch.world as world_mod

    fault(world_mod, monkeypatch)
    out = run(small_cell(work))
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("work", CELLS)
def test_control_is_not_correct(work, cpu_cuda_backend):
    cell = small_cell(work)
    for seed in (2, 3, 4):
        sc, snaps, _ = harness.simulate(cell, seed, 0.1, False, "cpu",
                                        time.perf_counter())
        got = judge.numbers(cell.config, sc, snaps, seed, "cpu",
                            post=judge.control_post(cell.config, sc, "cpu"))
        check = judge.checks(cell.config, got)
        assert not judge.passed(check), check


@pytest.mark.parametrize("work", CELLS)
def test_enqueue_is_at_most_the_substep_of_the_same_run(work, cpu_cuda_backend):
    """The host's time inside the program's calls is part of the window's
    wall time: ``enqueue_ms`` never reads above ``substep_ms`` of its run."""
    cell = small_cell(work)
    _, _, ctx = harness.simulate(cell, 17, 0.3, False, "cpu", time.perf_counter())
    kind = work.split("-")[0]
    enqueue = harness.reader(f"enqueue_ms.{kind}")(ctx)
    substep = harness.reader(f"substep_ms.{kind}")(ctx)
    assert 0 < enqueue <= substep


@pytest.mark.parametrize("reference", ["direct", "p3m"])
def test_reference_refuses_an_integrator_it_does_not_step(reference):
    """A configuration of another integrator is never judged as Euler."""
    from perfbench.reference import common

    mod = harness.module("reference", reference)
    cfg = {"dt": 0.01, "sim": {"integrator": "leapfrog", "pm_grid": 64,
                               "p3m_rc_cells": 4, "pm_softening": 2.0,
                               "p3m_cell_capacity": 8, "p3m_exact_targets": 4}}
    g = torch.Generator().manual_seed(1)
    scene = {"pos": torch.rand((200, 2), generator=g).numpy() * 100,
             "vel": torch.zeros((200, 2)).numpy(),
             "mass": torch.rand(200, generator=g).numpy(),
             "radius": torch.ones(200).numpy()}
    ref = common.partition(scene, "cpu")
    with pytest.raises(ValueError, match="leapfrog"):
        mod.step(cfg, ref, ref["pos"], ref["vel"])
    got = {"acc": ref["acc"], "vel": ref["vel"], "pos": ref["pos"]}
    with pytest.raises(ValueError, match="leapfrog"):
        mod.update_parts(cfg, ref["pos"], ref["vel"], got)
