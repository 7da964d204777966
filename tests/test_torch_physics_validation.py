"""nbody_tpu_torch.scripts.validate_physics on the CPU, against
scripts/validate_physics.py and tests/test_physics_validation.py.

The script at N=1024 (two galaxies, seed 11037, dt 0.005) on "torch"
(nbody_tpu's "jnp"), "pm" and "p3m", and the two symplectic integrators,
is held against the JAX script run through runpy with the same arguments:
the massive count equal, the total energy at each of the 4 checkpoints
within 1e-5 relative (the two packages sum the fp32 potential in different
orders: 1.5e-6 apart at the start), and |dp|/scale at each checkpoint
within DP_TOL of the JAX script's. "p3m" runs 4 substeps, not 40: the
default config's plain pair correction (128 x 128 cells of 96) costs
~2.3 s a substep on the CPU. The horizon helpers that chip_smoke.py runs
on the card are checked here on a shortened horizon, and their
``robust_metrics`` against the JAX file's own helper on the committed
10k-step goldens; the file's 10k-substep cases, copied at full horizon,
are marked slow as nbody_tpu's are."""

import re
import runpy
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch

from nbody_tpu_torch.scripts import validate_physics as vp

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "validate_physics.py"
CPU = torch.device("cpu")
E_TOL = 1e-5
# |dp|/scale is round-off: ~1e-8 on the exact backends, ~1e-6 on "pm"
DP_TOL = {"torch": 1e-7, "p3m": 1e-7, "pm": 1e-6}
LINE = re.compile(r"step +(\d+): E=(\S+) \(drift (\S+)\)  \|dp\|/scale=(\S+)")


def _jax_script(argv, monkeypatch, capsys):
    """The JAX script's checkpoint lines: [(step, E, drift, dp)], and its
    first line."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["validate_physics.py", *map(str, argv)])
    runpy.run_path(str(SCRIPT), run_name="__main__")
    out = capsys.readouterr().out
    assert "finite state: OK" in out
    rows = [tuple(float(x) for x in m.groups()) for m in LINE.finditer(out)]
    return rows, out.splitlines()[0]


@pytest.mark.parametrize("backend,jax_backend,integrator,steps", [
    ("torch", "jnp", "euler", 40),
    ("pm", "pm", "euler", 40),
    ("p3m", "p3m", "euler", 4),
    ("torch", "jnp", "leapfrog", 40),
    ("torch", "jnp", "yoshida4", 40),
])
def test_validate_physics_matches_the_jax_script(backend, jax_backend,
                                                 integrator, steps,
                                                 monkeypatch, capsys):
    got = vp.main(["1024", str(steps), backend, integrator, "--device", "cpu"])
    want, head = _jax_script([1024, steps, jax_backend, integrator],
                             monkeypatch, capsys)
    assert f"massive={got['mass_len']} " in head
    assert len(want) == len(got["rows"]) == vp.CHECKPOINTS
    assert got["finite"]
    for row, (step, e, _, dp) in zip(got["rows"], want):
        assert row["step"] == step
        assert abs(row["e"] - e) / abs(e) < E_TOL, (row, e)
        assert abs(row["dp"] - dp) < DP_TOL[backend], (row, dp)
    assert got["worst_drift"] == max(r["drift"] for r in got["rows"])


def test_validate_physics_prints_the_jax_scripts_lines(capsys):
    vp.main(["1024", "8", "torch", "euler", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("N=1024 massive=498 dt=0.005 steps=8 backend=torch "
                      "integrator=euler")
    assert out[1].startswith("start: E=")
    assert [int(LINE.match(x).group(1)) for x in out[2:6]] == [2, 4, 6, 8]
    assert out[6] == "finite state: OK"


def test_validate_physics_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vp.main(["1024", "4"])


# --- the horizon helpers, on a shortened horizon --------------------------

@pytest.mark.parametrize("case,backend", [
    ("exact", "torch"), ("pm", None), ("leapfrog", "torch"),
    ("yoshida4", "torch"), ("ring", None),
])
def test_horizon_cases_hold_their_bounds_over_20_substeps(case, backend):
    """Every case but "sharded_p3m" (~40 s for 20 substeps of its plain
    pair correction on 8 CPU shards; it runs at full horizon in the slow
    test below and on the card)."""
    c = vp.HORIZON_CASES[case]
    scene, world = vp.horizon_world(case, CPU, backend)
    if "shards" in c:
        assert world.n_devices == c["shards"]
        assert world.force_backend == c["backend"]
    r = vp.invariants(world, scene, CPU, chunks=2, substeps=10)
    assert len(r["drifts"]) == len(r["dp"]) == 2
    vp.check_invariants(case, r, c["drift"], c["dp"])


def test_invariants_match_the_jax_loop():
    """The drift of invariants() after each chunk against the loop of
    tests/test_physics_validation.py:50-55 run on nbody_tpu's "jnp"."""
    from nbody_tpu import create_world, make_galaxies
    from nbody_tpu.diagnostics import summary
    from nbody_tpu.types import SimConfig

    scene, world = vp.horizon_world("exact", CPU, "torch")
    got = vp.invariants(world, scene, CPU, chunks=2, substeps=20)
    js = make_galaxies(1024, 1, seed=11037)
    jw = create_world(js, config=SimConfig(tile_targets=128, tile_sources=128,
                                           precise=False),
                      default_backend="jnp")

    def energy(w):
        s = summary(w)
        return s["kinetic_energy"] + s["potential_energy"]

    e0 = energy(jw)
    for drift in got["drifts"]:
        jw.update(0.005, 20)
        assert abs(drift - abs(energy(jw) - e0) / abs(e0)) < 1e-5


def test_check_invariants_raises_past_each_bound():
    r = {"finite": True, "worst_drift": 2e-3, "worst_dp": 5e-7}
    vp.check_invariants("x", r, 3e-3, 1e-6)
    with pytest.raises(AssertionError, match="energy drift"):
        vp.check_invariants("x", r, 1e-3, 1e-6)
    with pytest.raises(AssertionError, match="dp"):
        vp.check_invariants("x", r, 3e-3, 1e-7)
    with pytest.raises(AssertionError, match="non-finite"):
        vp.check_invariants("x", {**r, "finite": False}, 3e-3, None)


# --- the reference binary's 10k-step rule ---------------------------------

from nbody_tpu.models.galaxy_ref import available as libm_available  # noqa: E402

needs_libm = pytest.mark.skipif(
    not libm_available(), reason="the bit-exact IC needs the platform libm")


def test_robust_metrics_equal_the_jax_files_helper():
    from test_physics_validation import _robust_metrics

    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    for flavor in ("", "scalar_"):
        rows = load_hex_dump(ROOT / "tests" / "data" / vp.GOLDEN.format(
            steps=10000).split("/")[-1].replace("ref_traj_",
                                                f"ref_traj_{flavor}"))
        for a, b in zip(vp.robust_metrics(rows), _robust_metrics(rows)):
            np.testing.assert_array_equal(a, b)


@needs_libm
def test_reference_goldens_and_self_noise_match_the_jax_file():
    """The goldens in world order equal the JAX file's, and the scalar
    build against the AVX build (the reference's own noise) is measured
    alike: tests/test_physics_validation.py:326-338."""
    from test_physics_validation import _bitexact_world_and_golden

    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.galaxy_ref import make_galaxies_libc

    ic = make_galaxies_libc(2000, 2, seed=11037)
    perm, _ = nt.partition_massive_first(ic.mass)
    avx, scalar = vp.reference_goldens(perm)
    np.testing.assert_array_equal(avx, _bitexact_world_and_golden(10000)[1])
    np.testing.assert_array_equal(
        scalar, _bitexact_world_and_golden(10000, flavor="scalar")[1])
    d = vp.reference_deviation(scalar, avx, scalar)
    assert d["ok"] and d["com"] == d["self_com"] and d["mom"] == d["self_mom"]
    # measured in the JAX file's docstring: self com 7.5e-4 of the median
    # radius, momentum 2.3e-2, radial quantiles <= 1.6e-1
    assert d["self_com"] == pytest.approx(7.5e-4, rel=0.05)
    assert d["self_mom"] == pytest.approx(2.3e-2, rel=0.05)
    assert max(d["self_rq"]) < 0.17
    far = avx.copy()
    far[:, :2] *= 1.5
    assert not vp.reference_deviation(far, avx, scalar)["ok"]


@needs_libm
def test_reference_binary_path_at_20_steps(monkeypatch):
    """The helper's path (bit-exact IC, precise, world order, mass
    bit-exact, the 4x self-noise rule) at 20 substeps, where only the AVX
    build's dump is committed: it stands for both builds, so every metric
    is held to 4x its floor."""
    from nbody_tpu_torch.utils.ref_dump import load_hex_dump

    def goldens(perm, steps, root):
        avx = load_hex_dump(Path(root) / vp.GOLDEN.format(steps=steps))
        return avx[np.asarray(perm)], avx[np.asarray(perm)]

    monkeypatch.setattr(vp, "reference_goldens", goldens)
    r = vp.reference_binary("torch", CPU, steps=20)
    assert r["ok"] and r["self_com"] == 0.0 and r["com"] < 1e-6


# --- tests/test_physics_validation.py's 10k cases, at full horizon --------

@pytest.mark.slow
@pytest.mark.parametrize("case,backend", [
    ("exact", "torch"), ("pm", None), ("leapfrog", "torch"),
    ("yoshida4", "torch"), ("ring", None),
])
def test_energy_momentum_bounded_over_10k_steps(case, backend):
    """Every case but "sharded_p3m": its plain pair correction on 8 CPU
    shards costs ~2 s a substep (hours for 10k); it runs on the card,
    tests/test_torch_scripts_cuda.py."""
    vp.run_horizon(case, CPU, backend)


@pytest.mark.slow
def test_default_math_vs_oracle_10k_steps_invariants():
    from nbody_tpu_torch.utils import cpp_oracle

    if not cpp_oracle.available():
        pytest.skip("cpp oracle not buildable")
    vp.oracle_horizon("torch", CPU)


@pytest.mark.slow
@needs_libm
def test_reference_binary_10k_steps():
    vp.reference_binary("torch", CPU)
