"""The yardstick's arithmetic and inputs: the roofline counts on known
shapes, the frozen scene against the program's generator, and the imports
of every module under perfbench/."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from perfbench import harness, scene
from perfbench.metrics import roofline
from perfbench.reference import p3m


def test_direct_bound_at_n65536():
    flops, nbytes = roofline.direct_substep(65536, 32833)
    least, by = roofline.least_s(flops, nbytes)
    assert by == "operations"
    assert least * 1e3 == pytest.approx(0.4175, abs=5e-5)


def test_pair_bound_counts_what_the_inputs_need():
    counts = {"live_t": 1000, "live_s": 500, "cells": 64, "n_t": 1200,
              "inside": 1_800_000}
    flops, nbytes = roofline.pair_substep(counts)
    assert flops == 14 * 1_800_000
    assert nbytes == 16 * 1500 + 16 * 64 + 8 * 1200
    least, by = roofline.least_s(flops, nbytes)
    assert by == "operations" and least == pytest.approx(flops / 67e12)


def test_pair_count_matches_brute_force():
    g = torch.Generator().manual_seed(3)
    pos = torch.rand((600, 2), generator=g) * 100.0
    gm = torch.rand(300, generator=g) + 0.1
    cfg = {"sim": {"pm_grid": 64, "p3m_cell_capacity": 1000, "p3m_rc_cells": 4}}
    got = roofline.pair_count(pos, gm, cfg)
    lo, h = p3m.box(pos, 64)
    rc = 4 * h
    d = pos[:, None, :] - pos[None, :300, :]
    want = int(((d * d).sum(-1) < rc * rc).sum())
    assert got["inside"] == want
    assert got["live_t"] == 600 and got["live_s"] == 300


@pytest.mark.parametrize("n,galaxies,seed", [(300, 2, 0), (2000, 2, 11037),
                                             (1500, 3, 2718281828)])
def test_frozen_scene_is_the_programs(n, galaxies, seed):
    from nbody_tpu_torch import galaxy

    mine = scene.make_galaxies(n, galaxies, scene.rng_of(seed))
    theirs = galaxy.make_galaxies(n, galaxies, seed=seed)
    for f in ("pos", "vel", "mass", "radius"):
        assert np.array_equal(mine[f], getattr(theirs, f).numpy()), f


def test_large_seeds_give_the_same_inputs():
    a = scene.make_galaxies(400, 2, scene.rng_of(2**31 + 12345))
    b = scene.make_galaxies(400, 2, scene.rng_of(2**31 + 12345))
    c = scene.make_galaxies(400, 2, scene.rng_of(2**31 + 12346))
    assert all(np.array_equal(a[f], b[f]) for f in a)
    assert not np.array_equal(a["pos"], c["pos"])


def imported_tops(path) -> set:
    """Top-level names (before the first dot) of every module ``path``
    imports, relative imports left out."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(harness.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert imported_tops(path) & {"jax", "jaxlib", "flax", "nbody_tpu"} == set()


@pytest.mark.parametrize("path", sorted((harness.BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    # plain PyTorch and numpy alone: nothing of the program or the harness
    assert imported_tops(path) <= {"__future__", "math", "numpy", "torch"}


def test_the_import_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nbody_tpu_torch_like", types.ModuleType("x"))
    assert "nbody_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.loaded_forbidden() == ["jax"]


def test_every_seed_asks_the_same_work():
    """A seed turns and shuffles the configuration's one scene: the same
    bodies, so the same sizes and the same massive rows, in another order."""
    spec = {"particles": 3000, "galaxies": 2, "seed": 11037}
    a, b = scene.deployment(spec, 1), scene.deployment(spec, 2**31 + 5)
    assert not np.array_equal(a["pos"], b["pos"])
    for f in ("mass", "radius"):
        assert np.array_equal(np.sort(a[f]), np.sort(b[f]))
    for s in (a, b):
        r = np.sort(np.hypot(*s["pos"].T.astype(np.float64)))
        base = scene.make_galaxies(3000, 2, scene.rng_of(11037))
        assert np.array_equal(r, np.sort(np.hypot(*base["pos"].T.astype(np.float64))))
    again = scene.deployment(spec, 1)
    assert all(np.array_equal(a[f], again[f]) for f in a)
