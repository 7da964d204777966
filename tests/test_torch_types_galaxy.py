"""The port's constants, config and scene generators against nbody_tpu's:
the numpy generators must give bitwise the same scenes for the same seed."""

import os

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import DATA, load_hex_dump

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.models import make_galaxies_libc as jax_make_galaxies_libc
from nbody_tpu_torch.models import make_galaxies_libc
from nbody_tpu_torch.models.galaxy_ref import available as libm_available
from nbody_tpu_torch.utils.libc_rand import LibcRand

needs_libm = pytest.mark.skipif(
    not libm_available(), reason="oracle needs the platform libm via ctypes")


def _rows(p):
    """Port Particles -> (N, 6) float32 in ref_scene_dump column order."""
    return np.concatenate(
        [p.pos.numpy(), p.vel.numpy(), p.mass.numpy()[:, None],
         p.radius.numpy()[:, None]], axis=1)


def test_constants_match():
    assert nt.G == nb.G
    assert nt.types.SOFTENING_FLOOR == nb.types.SOFTENING_FLOOR
    assert nt.DTYPE == torch.float32


@pytest.mark.parametrize("field", [
    "g", "precise", "integrator", "pm_grid", "pm_softening", "p3m_rc_cells",
    "p3m_cell_capacity", "p3m_exact_targets", "p3m_rebin_interval",
    "p3m_pp_chunk", "p3m_pp_compact"])
def test_sim_config_defaults_match(field):
    assert getattr(nt.SimConfig(), field) == getattr(nb.SimConfig(), field)


@pytest.mark.parametrize("kw", [
    dict(pm_grid=32), dict(pm_softening=0.0), dict(p3m_rc_cells=1),
    dict(p3m_cell_capacity=4), dict(p3m_exact_targets=-1),
    dict(p3m_rebin_interval=0), dict(p3m_pp_chunk=-1),
    dict(p3m_pp_compact=-1), dict(p3m_pp_chunk=0, p3m_pp_compact=512),
    dict(p3m_pp_chunk=64, p3m_pp_compact=96)])
def test_sim_config_same_errors(kw):
    with pytest.raises(ValueError) as want:
        nb.SimConfig(**kw)
    with pytest.raises(ValueError) as got:
        nt.SimConfig(**kw)
    assert str(got.value) == str(want.value)


def test_galaxy_config_matches():
    assert vars(nt.GalaxyConfig()) == vars(nb.GalaxyConfig())


def test_sim_config_rejects_unknown_integrator():
    with pytest.raises(ValueError):
        nt.SimConfig(integrator="rk4")


def test_make_particles_defaults_and_shapes():
    p = nt.make_particles(np.zeros((3, 2), np.float32))
    assert p.n == len(p) == 3
    assert torch.equal(p.radius, torch.ones(3))
    assert torch.equal(p.mass, torch.zeros(3))
    assert all(x.dtype == torch.float32 for x in vars(p).values())
    with pytest.raises(ValueError):
        nt.make_particles(np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        nt.make_particles(np.zeros((3, 2), np.float32), mass=np.ones(4))
    assert p.slice_to(2).n == 2


@pytest.mark.parametrize("n,g,seed", [(300, 1, 0), (1000, 2, 11037), (2000, 3, 5)])
def test_make_galaxies_bitwise_equal(n, g, seed):
    got = nt.make_galaxies(n, g, seed=seed)
    want = nb.make_galaxies(n, g, seed=seed)
    for name in ("pos", "vel", "acc", "mass", "radius"):
        t = getattr(got, name)
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("n,g", [(150, 2), (99, 1), (500, 0)])
def test_make_galaxies_same_errors(n, g):
    with pytest.raises(ValueError) as want:
        nb.make_galaxies(n, g)
    with pytest.raises(ValueError) as got:
        nt.make_galaxies(n, g)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [1, 11037, 3017237295])
def test_libc_rand_is_the_same_stream(seed):
    from nbody_tpu.utils.libc_rand import LibcRand as JaxLibcRand

    assert LibcRand(seed).draw(400) == JaxLibcRand(seed).draw(400)


@needs_libm
@pytest.mark.parametrize("n,g,seed", [(2000, 2, 11037), (5000, 3, 1),
                                      (300, 1, 3017237295)])
def test_make_galaxies_libc_bitwise(n, g, seed):
    """Bitwise equal to the JAX package's oracle and to the committed dumps
    of the reference's own MakeGalaxies."""
    got = _rows(make_galaxies_libc(n, g, seed=seed))
    want = jax_make_galaxies_libc(n, g, seed=seed)
    np.testing.assert_array_equal(got[:, :2], np.asarray(want.pos))
    np.testing.assert_array_equal(got[:, 4], np.asarray(want.mass))
    dump = load_hex_dump(os.path.join(DATA, f"ref_scene_n{n}_g{g}_seed{seed}.hex"))
    np.testing.assert_array_equal(got, dump)


def test_make_galaxies_libc_validates():
    with pytest.raises(ValueError):
        make_galaxies_libc(150, 2)
