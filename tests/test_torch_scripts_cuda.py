"""nbody_tpu_torch.scripts and the compile cache on the card, at reduced
size: the items of chip_smoke.py's [23] (physics at horizon) with short
horizons, the reference binary's 10k-step state on the direct kernel in
full, and tests/test_physics_validation.py's sharded "p3m" 10k case
(marked slow: ~1000 PyTorch ops a substep at D=8, minutes on the card).

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor nbody_tpu; run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scripts_cuda.py -q
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_helpers import cuda  # noqa: F401 (fixture)

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.scripts import scale_ceiling, validate_physics as vp
from nbody_tpu_torch.scripts import verify_drive
from nbody_tpu_torch.utils.compile_cache import cache_entries, enable_compile_cache

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


def test_reference_binary_10k_steps_on_the_kernel(cuda):
    df.LAUNCHES = 0
    r = vp.reference_binary("cuda", cuda)
    assert r["ok"] and df.LAUNCHES == vp.REF_STEPS


@pytest.mark.parametrize("case,backend", [
    ("exact", "cuda"), ("exact", "torch"), ("pm", None),
    ("leapfrog", "cuda"), ("yoshida4", "cuda"), ("ring", None),
])
def test_horizon_cases_over_500_substeps(cuda, case, backend):
    c = vp.HORIZON_CASES[case]
    scene, world = vp.horizon_world(case, cuda, backend)
    df.LAUNCHES = rf.LAUNCHES = 0
    r = vp.invariants(world, scene, cuda, chunks=2, substeps=250)
    vp.check_invariants(case, r, c["drift"], c["dp"])
    if case == "ring":
        assert rf.LAUNCHES == c["shards"] ** 2 * 500
    elif backend == "cuda":
        assert df.LAUNCHES == 500 * (3 if case == "yoshida4" else 1)
    assert r["device_ms"] > 0


def test_pm_momentum_over_2000_substeps(cuda):
    """The "pm" horizon case's momentum on the card: with an fp32 solve,
    cuFFT's rounding at the core's cells drifted it 1.05e-4 of its scale
    in 2000 substeps, linearly (6.7e-4 at 10,000, past the 2e-4 bound);
    the CPU's fp32 FFT 6.8e-6, the float64 solve 5.5e-7 (H100 80GB HBM3,
    700 W; ``python -m nbody_tpu_torch.ablations.pm_momentum``)."""
    scene, world = vp.horizon_world("pm", cuda)
    r = vp.invariants(world, scene, cuda, chunks=4, substeps=500)
    assert r["worst_dp"] < 2e-5, r["dp"]


def test_oracle_horizon_on_the_kernel(cuda):
    from nbody_tpu_torch.utils import cpp_oracle

    if not cpp_oracle.available():
        pytest.skip("the native oracle cannot be built")
    r = vp.oracle_horizon("cuda", cuda, steps=2000)
    assert r["mom"] <= 1e-3


@pytest.mark.parametrize("argv,drift", [
    (["16384", "40", "cuda"], 1e-3), (["65536", "8", "p3m"], 5e-3),
    (["65536", "8", "pm"], 5e-3), (["16384", "40", "cuda", "yoshida4"], 1e-3),
])
def test_validate_physics_rows(cuda, argv, drift):
    r = vp.main(argv)
    assert r["finite"] and r["worst_drift"] < drift and r["device_ms"] > 0


def test_scale_ceiling_at_1m(cuda):
    r = scale_ceiling.main(["1048576", "512", "2"])
    assert r["ms"] > 0 and 0 < r["peak_gib"] < r["total_gib"]
    assert torch.isfinite(r["world"].state.pos).all()


def test_verify_drive_on_the_card(cuda, tmp_path):
    r = verify_drive.main(["6000", "200", "--out", str(tmp_path / "f.ppm")])
    assert r["mix"] == ("torch", "cuda") and r["mix_err"] < 1e-5


def test_compile_cache_builds_once_and_a_new_process_loads(cuda, tmp_path):
    cache = tmp_path / "cache"
    try:
        enable_compile_cache(str(cache))
        path, cold = _build.build_all(["direct_forces"])["direct_forces"]
        assert path.parent == cache and cold > 0
        assert _build.build_all(["direct_forces"])["direct_forces"] == (path, 0.0)
    finally:
        _build.set_build_dir(None)
    assert cache_entries(str(cache)) == 1
    stamp = path.stat().st_mtime_ns
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "--compile-cache",
         str(cache), "run", "--n", "2000", "--steps", "5"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "1 libraries; built in this process: none" in proc.stderr
    assert path.stat().st_mtime_ns == stamp
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])


@pytest.mark.slow
def test_sharded_p3m_energy_momentum_bounded_over_10k_steps(cuda):
    """tests/test_physics_validation.py:140's "p3m" case: D=8 shards on
    one card, N=512, 10,000 substeps."""
    vp.run_horizon("sharded_p3m", cuda)
