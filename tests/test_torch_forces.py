"""The port's plain force math and its kernel wrappers (which take the plain
version for CPU tensors) against nbody_tpu's jnp forces and its Pallas
kernels in interpret mode, on the same numpy inputs.

Tolerance: max|Δ|/max|ref| < 1e-6 wherever a force is compared. Both sides
are fp32 with the same formula, so they differ only in the order of the
S-term sums (and in XLA's fusion); measured up to 2e-7 at S = 200.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import random_arrays, rel_err

from nbody_tpu import forces as jax_forces
from nbody_tpu.ops import pallas_forces as jax_pallas
from nbody_tpu_torch import forces
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import direct_forces as df

TOL = 1e-6
T, S = 256, 200        # S is deliberately not a multiple of 128
S_PAD = 256            # the Pallas kernel wants S padded to 128 lanes


def _inputs(seed=0):
    pos, vel, mass, radius = random_arrays(T, seed=seed, massless_frac=0.0)
    gm = (10.0 * mass[:S]).astype(np.float32)
    return pos, vel, radius, gm


def _padded_src(pos, gm):
    sp = np.zeros((S_PAD, 2), np.float32)
    sp[:S] = pos[:S]
    sg = np.zeros(S_PAD, np.float32)
    sg[:S] = gm
    return sp, sg


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("precise", [True, False])
def test_pair_acc_matches_jnp(precise):
    pos, _, radius, gm = _inputs()
    want = jax_forces.pair_acc(pos, radius, pos[:S], gm, precise=precise)
    got = forces.pair_acc(*_t(pos, radius, pos[:S], gm), precise=precise)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, 2)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("chunk", [None, 64, 100, T])
def test_direct_sum_acc_matches_jnp(precise, chunk):
    """Whole, evenly chunked, ragged-chunked (100 does not divide 256)."""
    pos, _, radius, gm = _inputs(seed=1)
    want = jax_forces.direct_sum_acc(pos, radius, pos[:S], gm, chunk=64,
                                     precise=precise)
    got = forces.direct_sum_acc(*_t(pos, radius, pos[:S], gm), chunk=chunk,
                                precise=precise)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("precise", [True, False])
def test_force_acc_matches_pallas_acc(precise):
    pos, _, radius, gm = _inputs(seed=2)
    sp, sg = _padded_src(pos, gm)
    want = jax_pallas.pallas_acc(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(sp), jnp.asarray(sg),
        tile_targets=128, tile_sources=128, precise=precise, interpret=True)
    got = df.force_acc(*_t(pos, radius, pos[:S], gm), precise=precise)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("pos_dt", [1.0, 0.5])
def test_fused_substep_matches_pallas(precise, pos_dt):
    pos, vel, radius, gm = _inputs(seed=3)
    sp, sg = _padded_src(pos, gm)
    src = jnp.concatenate([jnp.transpose(jnp.asarray(sp)), jnp.asarray(sg)[None]], 0)
    want = jax_pallas.fused_substep(
        0.01, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(radius),
        jnp.ones((T, 1), jnp.float32), src, tile_targets=128,
        tile_sources=128, precise=precise, pos_dt=pos_dt, interpret=True)
    got = df.fused_substep(0.01, *_t(pos, vel, radius, gm), precise=precise,
                           pos_dt=pos_dt)
    for name, g, w in zip(("pos", "vel", "acc"), got, want):
        assert rel_err(g, w) < TOL, name


def test_integrate_matches_jnp():
    """XLA's CPU backend fuses v + dt*a into one FMA, PyTorch rounds dt*a
    first: 1 ulp in v, carried into x (measured 9e-8 of max|x|)."""
    pos, vel, _, _ = _inputs(seed=4)
    acc = (1e3 * np.random.default_rng(4).normal(size=(T, 2))).astype(np.float32)
    want = jax_forces.integrate(pos, vel, acc, 0.01)
    got = forces.integrate(*_t(pos, vel, acc), 0.01)
    for g, w in zip(got, want):
        assert rel_err(g, w) < 1e-6


@pytest.mark.parametrize("precise", [True, False])
def test_zero_radius_tracer_on_zero_gm_source_is_zero(precise):
    """The softening floor: a radius-0 target on top of a gm = 0 source
    gets exactly 0, not 0/0 = NaN."""
    pos = torch.zeros((2, 2))
    radius = torch.zeros(2)
    gm = torch.zeros(2)
    acc = df.force_acc(pos, radius, pos, gm, precise=precise)
    assert torch.equal(acc, torch.zeros((2, 2)))
    npos, nvel, acc = df.fused_substep(0.01, pos, torch.ones((2, 2)), radius, gm,
                                       precise=precise)
    assert torch.equal(acc, torch.zeros((2, 2)))
    assert torch.isfinite(npos).all() and torch.isfinite(nvel).all()


def test_no_sources_gives_zero_force_and_drift():
    pos, vel, radius, _ = _t(*_inputs()[:3], np.zeros(0, np.float32))
    gm = torch.zeros(0)
    npos, nvel, acc = df.fused_substep(0.5, pos, vel, radius, gm)
    assert torch.equal(acc, torch.zeros_like(acc))
    assert torch.equal(nvel, vel)
    torch.testing.assert_close(npos, pos + 0.5 * vel, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device", "gm_len"])
def test_wrappers_refuse_bad_inputs(bad):
    """Wrong inputs raise; nothing falls through to the plain version."""
    pos, vel, radius, gm = _t(*_inputs())
    if bad == "dtype":
        pos = pos.double()
    elif bad == "shape":
        radius = radius[:-1]
    elif bad == "contiguous":
        vel = vel.t().contiguous().t()
    elif bad == "device":
        pos, vel, radius, gm = (x.to("meta") for x in (pos, vel, radius, gm))
    elif bad == "gm_len":
        gm = torch.ones(T + 1)
    with pytest.raises((TypeError, ValueError)):
        df.fused_substep(0.01, pos, vel, radius, gm)


def test_plain_calls_do_not_count_as_launches():
    pos, vel, radius, gm = _t(*_inputs())
    before = df.LAUNCHES
    df.fused_substep(0.01, pos, vel, radius, gm)
    df.force_acc(pos, radius, pos[:S], gm)
    assert df.LAUNCHES == before


def test_kernel_args_take_the_source_count_from_gm():
    """The fused substep hands the kernel all of pos as sources; only the
    first len(gm) rows may be read."""
    pos, vel, radius, gm = _t(*_inputs())
    out = [torch.empty((T, 2)) for _ in range(3)]
    plan = df.Plan(2, 1)
    args = df._kernel_args(pos, vel, radius, pos, gm, 0.01, 0.5, True, *out,
                           plan)
    argtypes = _build.SIGNATURES["direct_forces"]["nbody_direct_forces"]
    assert len(args) == len(argtypes) - 1   # the stream comes last
    assert args[5:11] == (T, S, 0.01, 0.5, 1, 1)
    assert args[11:14] == (2, 1, None)   # the plan, no scratch
    assert args[3] == pos.data_ptr() and args[4] == gm.data_ptr()
    args = df._kernel_args(pos, None, radius, pos[:S], gm, 0.0, 1.0, False,
                           out[0], None, None, plan)
    assert args[1] is None and args[-2:] == (None, None)
    assert args[5:11] == (T, S, 0.0, 1.0, 0, 0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_sources():
    """One library per source, and every source has declared signatures."""
    path = _build.library_path("direct_forces")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdirect_forces-") and path.suffix == ".so"
    assert _build.source("direct_forces").name == "direct_forces.cu"
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == sorted(_build.SIGNATURES)



# --- the CPU square root: correctly rounded, the same in every process ---

@pytest.mark.parametrize("lo,hi", [(0.5, 2e6), (1e-30, 1e-20), (1e20, 3e38)])
def test_cpu_sqrt_is_numpys_and_jnps_on_every_element(lo, hi):
    """forces.sqrt on the CPU equals np.sqrt and jnp.sqrt on every element
    of 1e6 fp32 inputs; PyTorch's CPU torch.sqrt is off by 1 ulp on about
    0.6% of them (5697 of the first range)."""
    x = np.random.default_rng(0).uniform(lo, hi, 1_000_000).astype(np.float32)
    got = forces.sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(x)))


def test_cpu_sqrt_keeps_shape_and_strides_of_views():
    x = torch.arange(1.0, 25.0).reshape(4, 6)
    for view in (x[:, ::2], x.t(), x[1, 2]):
        got = forces.sqrt(view)
        assert got.shape == view.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.sqrt(view.numpy()))


def test_precise_plain_versions_repeat_in_fresh_processes():
    """direct_sum_acc(precise=True) at N=4096 (first), pp_cells, K5f's
    sqrt chain, the merge pass and its scatter, three calls each in three
    fresh processes at 8 threads: one hash each. With torch.sqrt the first
    call of a process sometimes computed one thread's share of the
    elements to ~12 bits."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch.utils.sqrt_repeat",
         "--processes", "3", "--first", "direct"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.splitlines()[-1])
    assert summary["sqrt"] == "forces.sqrt"
    assert len(summary["results"]) == 8
    for key, res in summary["results"].items():
        assert res == {"distinct": 1, "processes_moved": 0}, key
    assert summary["block"]["processes_moved"] == 0
    assert summary["block"]["max_rel_err"] < 6e-8   # half an ulp
