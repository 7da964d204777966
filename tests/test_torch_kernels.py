"""The CUDA kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor nbody_tpu, so it runs on a machine that has only
PyTorch; there, run it without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerance: max|Δ|/max|ref| < 1e-5 on forces. Kernel and plain version run
the same fp32 formula; they differ in the order of the S-term sums, in FMA
contraction, and (rsqrt path) in the hardware rsqrt's last bits. The fused
epilogue is held to 1e-6 against the plain update applied to the kernel's
own force: there the only difference is FMA contraction, ~1 ulp. (Holding
the new positions to the plain positions directly would scale the force
error by dt² max|a| / max|x|, which a zero-radius tracer makes large.)
"""

import numpy as np
import pytest
import torch
from torch_helpers import cuda, random_arrays, rel_err  # noqa: F401 (fixture)

import nbody_tpu_torch as nt
from nbody_tpu_torch.ops import direct_forces as df

pytestmark = pytest.mark.cuda

TOL = 1e-5
EPILOGUE_TOL = 1e-6


def _inputs(device, n, n_src, seed=0, zero_radius_tracers=True):
    pos, vel, mass, radius = random_arrays(n, seed=seed)
    if zero_radius_tracers:
        radius = np.where(mass == 0, 0.0, radius).astype(np.float32)
    gm = (10.0 * np.maximum(mass[:n_src], 1.0)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (pos, vel, radius, gm)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("n,n_src", [(1000, 333), (1000, 0), (257, 1), (300, 300),
                                     (4096, 3000)])
def test_force_acc_matches_plain(cuda, precise, n, n_src):
    pos, _, radius, gm = _inputs(cuda, n, n_src)
    got = df.force_acc(pos, radius, pos[:n_src], gm, precise=precise)
    want = df.force_acc_plain(pos, radius, pos[:n_src], gm, precise=precise)
    torch.cuda.synchronize()
    if n_src == 0:
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert rel_err(got.cpu(), want.cpu()) < TOL


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("pos_dt", [1.0, 0.5])
def test_fused_substep_matches_plain(cuda, precise, pos_dt):
    pos, vel, radius, gm = _inputs(cuda, 1000, 333)
    npos, nvel, acc = df.fused_substep(0.01, pos, vel, radius, gm,
                                       precise=precise, pos_dt=pos_dt)
    _, _, acc_w = df.fused_substep_plain(0.01, pos, vel, radius, gm,
                                         precise=precise, pos_dt=pos_dt)
    assert rel_err(acc.cpu(), acc_w.cpu()) < TOL
    nvel_w = vel + 0.01 * acc
    npos_w = pos + df._pos_dt_times_dt(pos_dt, 0.01) * nvel
    assert rel_err(nvel.cpu(), nvel_w.cpu()) < EPILOGUE_TOL
    assert rel_err(npos.cpu(), npos_w.cpu()) < EPILOGUE_TOL
    # inputs untouched (Jacobi: the kernel writes fresh buffers)
    assert npos.data_ptr() != pos.data_ptr() and nvel.data_ptr() != vel.data_ptr()


def test_streamed_source_count_matches_plain(cuda):
    """More sources than the TPU kernel kept resident (131072): the same
    kernel, a longer tile loop. The plain version runs on 512 targets."""
    n_src = 140_000
    pos, _, radius, gm = _inputs(cuda, n_src, n_src, seed=3)
    got = df.force_acc(pos[:512].contiguous(), radius[:512].contiguous(),
                       pos, gm)
    want = df.force_acc_plain(pos[:512], radius[:512], pos, gm)
    assert rel_err(got.cpu(), want.cpu()) < 1e-4


@pytest.mark.parametrize("precise", [True, False])
def test_zero_radius_tracer_on_zero_gm_source_is_zero(cuda, precise):
    pos = torch.zeros((2, 2), device=cuda)
    radius = torch.zeros(2, device=cuda)
    acc = df.force_acc(pos, radius, pos, torch.zeros(2, device=cuda), precise=precise)
    assert torch.equal(acc.cpu(), torch.zeros((2, 2)))


def test_non_contiguous_cuda_input_raises(cuda):
    """A CUDA tensor launches the kernel or raises: no plain fallback."""
    pos, vel, radius, gm = _inputs(cuda, 64, 10)
    with pytest.raises(ValueError):
        df.fused_substep(0.01, pos, vel.t().contiguous().t(), radius, gm)


@pytest.mark.parametrize("integrator,per_substep", [("euler", 1), ("leapfrog", 1),
                                                    ("yoshida4", 3)])
def test_world_cuda_matches_torch_backend(cuda, integrator, per_substep):
    p = nt.make_galaxies(2000, 2, seed=11037)
    cfg = nt.SimConfig(integrator=integrator)
    w_k = nt.create_world(p, config=cfg, device=cuda)
    w_p = nt.create_world(p, config=cfg, device=cuda)
    assert w_k.default_backend == "cuda"
    df.LAUNCHES = 0
    w_k.update(0.01, 5)
    assert df.LAUNCHES == 5 * per_substep
    w_p.update(0.01, 5, backend="torch")
    assert df.LAUNCHES == 5 * per_substep
    for name in ("pos", "vel", "acc"):
        got, want = getattr(w_k.particles, name), getattr(w_p.particles, name)
        assert rel_err(got, want) < TOL, name
