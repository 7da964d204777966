"""The port's shard-native checkpoints (nbody_tpu_torch/utils/checkpoint.py,
on torch.distributed.checkpoint) on 4 CPU shards, against the Orbax paths
of nbody_tpu (tests/test_checkpoint.py:63-200 and its scene,
make_galaxies(250, 1, seed=6)): the restored padded state and the resumed
run bit-equal to the uninterrupted world on every backend that runs on CPU
shards, the Orbax run of the same scene at the packages' tolerance, the
layout check, the resize through the host path, no gather of the state,
and the config sidecar."""

import dataclasses
import re

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
from torch_helpers import rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu.utils import checkpoint as jck
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh, multihost
from nbody_tpu_torch.utils import checkpoint as ck

FIELDS = ("pos", "vel", "acc", "mass", "radius")
# tests/helpers.py's TINY tiles on both sides; the mesh cut to CPU size
TINY = nt.SimConfig(tile_targets=8, tile_sources=128, pm_grid=128,
                    p3m_cell_capacity=32)
TINY_JAX = nb.SimConfig(tile_targets=8, tile_sources=128, pm_grid=128,
                        p3m_cell_capacity=32)
# tests/test_torch_sharding.py:27, between the packages
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}
BACKENDS = ("torch", "cuda", "cuda_ring", "pm", "p3m")
D = 4


def _mesh(d=D):
    return make_mesh(devices=["cpu"] * d)


def _scene(n=250):
    return nt.make_galaxies(n, 1, seed=6)


def _saved(tmp_path, backend, step=3):
    sw = ShardedWorld(_scene(), _mesh(), config=TINY, force_backend=backend)
    sw.update(0.01, step)
    path = str(tmp_path / f"ck_{backend}")
    ck.save_world_dcp(path, sw, step=step)
    return sw, path


def _shards_equal(a, b):
    for f in FIELDS:
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert torch.equal(x, y), f


@pytest.mark.parametrize("backend", BACKENDS)
def test_dcp_round_trip_resumes_bit_equal(tmp_path, backend):
    """The restored world holds the saved padded state bit for bit, each
    shard on its mesh device, and update(0.01, 2) on it is bit-equal to
    the uninterrupted world's ("p3m"'s frozen bins rebuild from the
    state)."""
    sw, path = _saved(tmp_path, backend)
    mesh = _mesh()
    sw2, step = ck.load_sharded_world_dcp(path, mesh, force_backend=backend)
    assert step == 3 and sw2.config == TINY
    assert (sw2.total_len, sw2.mass_len, sw2.n_pad, sw2.n_devices) == \
        (sw.total_len, sw.mass_len, sw.n_pad, sw.n_devices)
    _shards_equal(sw2, sw)
    for f in FIELDS:
        for k, x in enumerate(getattr(sw2, f)):
            assert x.device == mesh[k]
    assert torch.equal(sw2.gm_src, sw.gm_src)
    sw.update(0.01, 2)
    sw2.update(0.01, 2)
    _shards_equal(sw2, sw)


def test_dcp_run_matches_nbody_tpu_orbax(tmp_path):
    """The same scene through nbody_tpu's save_world_orbax ->
    load_sharded_world_orbax -> update on its 4-device mesh ("jnp"), held
    against the port's DCP round trip ("torch")."""
    jw = jsh.ShardedWorld(nb.make_galaxies(250, 1, seed=6), jsh.make_mesh(D),
                          config=TINY_JAX, force_backend="jnp")
    jw.update(0.01, 3)
    jck.save_world_orbax(str(tmp_path / "orbax"), jw, step=3)
    jw2, jstep = jck.load_sharded_world_orbax(str(tmp_path / "orbax"),
                                              jsh.make_mesh(D),
                                              force_backend="jnp")
    jw2.update(0.01, 2)
    sw, path = _saved(tmp_path, "torch")
    sw2, step = ck.load_sharded_world_dcp(path, _mesh(), force_backend="torch")
    sw2.update(0.01, 2)
    assert step == jstep == 3 and sw2.n_pad == jw2.n_pad
    got, want = sw2.particles, jw2.particles
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want.mass))
    for name, tol in WORLD_TOL.items():
        err = rel_err(getattr(got, name), getattr(want, name))
        assert err < tol, (name, err)


def test_dcp_mismatched_mesh_raises_padded_size(tmp_path):
    _, path = _saved(tmp_path, "torch", step=0)
    with pytest.raises(ValueError, match="padded size.*load_world_dcp"):
        ck.load_sharded_world_dcp(path, _mesh(8), config=TINY)


def test_dcp_resize_via_host_path(tmp_path):
    """A checkpoint of 4 shards restores onto 8 through load_world_dcp (the
    host path, nbody_tpu's resize recipe) with the same state, and runs on
    as nbody_tpu's test holds it."""
    sw, path = _saved(tmp_path, "torch")
    sw8, step = ck.load_world_dcp(path, ShardedWorld, mesh=_mesh(8),
                                  force_backend="torch")
    assert step == 3 and sw8.n_devices == 8 and sw8.config == TINY
    for f in FIELDS:
        assert torch.equal(getattr(sw8.particles, f), getattr(sw.particles, f))
    sw.update(0.01, 2)
    sw8.update(0.01, 2)
    np.testing.assert_allclose(sw8.particles.pos.numpy(),
                               sw.particles.pos.numpy(), atol=1e-6)


def test_dcp_world_round_trip(tmp_path):
    """A World is one shard: load_world_dcp rebuilds it bit-equal and it
    runs on bit-equal; a class without config= still loads."""
    w = nt.create_world(_scene(), config=TINY, device="cpu")
    w.update(0.01, 2)
    path = str(tmp_path / "world")
    ck.save_world_dcp(path, w, step=2)
    w2, step = ck.load_world_dcp(path, device="cpu")
    assert step == 2 and w2.config == TINY
    for f in FIELDS:
        assert torch.equal(getattr(w2.state, f), getattr(w.state, f))
    w.update(0.01, 3)
    w2.update(0.01, 3)
    assert torch.equal(w2.state.pos, w.state.pos)

    class Bare:
        def __init__(self, particles):
            self.particles = particles

    bare, step = ck.load_world_dcp(path, world_cls=Bare)
    assert step == 2 and bare.particles.pos.shape == (250, 2)


def test_dcp_paths_gather_nothing(tmp_path, monkeypatch):
    """Neither the save, the sharded load nor from_arrays gathers the
    state: the whole-state views raise, and no torch.cat yields n_pad
    rows."""
    sw = ShardedWorld(_scene(), _mesh(), config=TINY, force_backend="cuda_ring")
    sw.update(0.01, 2)

    def refuse(*args, **kw):
        raise AssertionError("gathered the whole state")

    monkeypatch.setattr(ShardedWorld, "particles", property(refuse))
    monkeypatch.setattr(ShardedWorld, "state", property(refuse))
    monkeypatch.setattr(multihost, "gather_particles", refuse)
    rows = []
    cat = torch.cat

    def spy(*args, **kw):
        out = cat(*args, **kw)
        rows.append(out.shape[0] if out.dim() else 0)
        return out

    monkeypatch.setattr(torch, "cat", spy)
    path = str(tmp_path / "ck")
    ck.save_world_dcp(path, sw, step=2)
    sw2, _ = ck.load_sharded_world_dcp(path, _mesh(), force_backend="cuda_ring")
    sw3 = ShardedWorld.from_arrays(sw.pos, sw.vel, sw.acc, sw.mass, sw.radius,
                                   total_len=sw.total_len,
                                   mass_len=sw.mass_len, mesh=_mesh(),
                                   config=TINY, force_backend="cuda_ring")
    assert sw.n_pad not in rows, rows
    monkeypatch.undo()
    _shards_equal(sw2, sw)
    _shards_equal(sw3, sw)


def test_from_arrays_shape_mismatch_message():
    """from_arrays on a CPU mesh (no CUDA) still raises on a shape that
    does not fit the layout, with its message, for a whole tensor and for
    a list of shards."""
    sw = ShardedWorld(_scene(), _mesh(), config=TINY, force_backend="torch")
    kw = dict(total_len=sw.total_len, mass_len=sw.mass_len, mesh=_mesh(),
              config=TINY)
    pos = torch.cat(sw.pos)
    want = (f"restored pos shape ({sw.n_pad - 8}, 2) does not match the "
            f"layout for n=250, mass_len={sw.mass_len}, D=4: ({sw.n_pad}, 2) "
            "on this process; restore with the same config and mesh size as "
            "the save")
    with pytest.raises(ValueError, match=re.escape(want)):
        ShardedWorld.from_arrays(pos[:-8], sw.vel, sw.acc, sw.mass,
                                 sw.radius, **kw)
    with pytest.raises(ValueError, match="restored pos shape .* does not "
                       "match the layout"):
        ShardedWorld.from_arrays(sw.pos[:3], sw.vel, sw.acc, sw.mass,
                                 sw.radius, **kw)


def test_dcp_sidecar_restores_sim_config(tmp_path):
    """The save-time SimConfig rides in config.json in nbody_tpu's payload;
    a bare restore rebuilds its layout (N=3000, where TINY's layout is not
    the default config's), and an explicit config wins."""
    import json

    cfg = dataclasses.replace(TINY, integrator="leapfrog")
    sw = ShardedWorld(_scene(3000), _mesh(), config=cfg, force_backend="torch")
    path = str(tmp_path / "ck")
    ck.save_world_dcp(path, sw, step=1)
    with open(f"{path}/config.json") as f:
        payload = json.load(f)
    assert payload["format"] == 1
    assert jck.config_from_dict(payload["sim_config"]).integrator == "leapfrog"
    sw2, step = ck.load_sharded_world_dcp(path, _mesh(), force_backend="torch")
    assert step == 1 and sw2.config == cfg
    _shards_equal(sw2, sw)
    w, _ = ck.load_world_dcp(path, device="cpu", config=TINY)
    assert w.config == TINY
    # a save over an old checkpoint drops the old sidecar first
    ck.save_world_dcp(path, ShardedWorld(_scene(3000), _mesh(),
                                         force_backend="torch"), step=4)
    assert ck.load_sharded_world_dcp(path, _mesh())[0].config == \
        nt.DEFAULT_SIM_CONFIG


def test_dcp_unreadable_sidecar_warns(tmp_path):
    _, path = _saved(tmp_path, "torch", step=0)
    with open(f"{path}/config.json", "w") as f:
        f.write('{"format": 1, "sim_co')
    with pytest.warns(UserWarning, match="config sidecar"):
        w, _ = ck.load_world_dcp(path, device="cpu")
    assert w.config == nt.DEFAULT_SIM_CONFIG
