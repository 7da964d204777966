"""The port's multi-process operation (nbody_tpu_torch/parallel/multihost.py)
on the CPU: 2 processes x 4 CPU shards joined over Gloo
(tests/torch_multihost_worker.py), the stand-in for one process per card
under NCCL. Every rank must hold the bits of the single-process world over
the same 8 shards; the "torch" run is held against nbody_tpu's 8-device
ShardedWorld, as tests/test_torch_sharding.py holds the single-process
one. Then the single-process and group-of-one forms, and the refusals."""

import os
import socket
import subprocess
import sys

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_multihost_worker as worker
from torch_helpers import rel_err

import nbody_tpu as nb
import nbody_tpu_torch as nt
from nbody_tpu.parallel import sharding as jsh
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh, multihost
from nbody_tpu_torch.parallel import sharding as sh
from nbody_tpu_torch.utils.checkpoint import load_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
FIELDS = ("pos", "vel", "acc", "mass", "radius")
# tests/test_torch_sharding.py:27
WORLD_TOL = {"pos": 1e-6, "vel": 2e-6, "acc": 5e-6}
PROCS = 2
D = PROCS * worker.LOCAL


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _scene():
    return nt.make_galaxies(worker.N, worker.GALAXIES, seed=worker.SEED)


def _config():
    return nt.SimConfig(**worker.CONFIG)


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """Run the 2-process job once (every backend); the tests read its
    files. Two attempts: the free port is closed before the first rank
    binds it, so another process may take it in between."""
    last_logs = ""
    for attempt in range(2):
        outdir = tmp_path_factory.mktemp(f"torch_multihost{attempt}")
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(i), str(PROCS), str(port),
             str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO, env=env) for i in range(PROCS)]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                pytest.fail("torch multihost worker hung (rendezvous or a "
                            "collective)")
            logs.append(out)
        if all(p.returncode == 0 for p in procs):
            return outdir, {b: [dict(np.load(outdir / f"proc{i}_{b}.npz"))
                                for i in range(PROCS)]
                            for b in worker.BACKENDS}
        last_logs = "\n".join(logs)
    pytest.fail(f"torch multihost workers failed twice:\n{last_logs[-3000:]}")


@pytest.fixture(scope="module")
def single_process():
    """The same runs on one process over the 8 CPU shards."""
    out = {}
    for backend in worker.BACKENDS:
        sw = ShardedWorld(_scene(), make_mesh(devices=["cpu"] * D),
                          config=_config(), force_backend=backend)
        sw.update(worker.DT, worker.SUBSTEPS)
        fixed = sw.particles
        k = sw.update_adaptive(worker.SPAN, dt_max=worker.DT_MAX)
        out[backend] = {"fixed": fixed, "k": k, "final": sw.particles,
                        "gm_src": sw.gm_src}
    return out


@pytest.mark.parametrize("backend", worker.BACKENDS)
def test_ranks_agree(worker_outputs, backend):
    """gather_particles hands every rank the same bits, and both ranks took
    the same adaptive substep count."""
    a, b = worker_outputs[1][backend]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert int(a["k_adaptive"]) >= 2


@pytest.mark.parametrize("backend", worker.BACKENDS)
def test_matches_single_process_world(worker_outputs, single_process,
                                      backend):
    """2 processes x 4 shards are bit-equal to one process over 8 shards,
    after the fixed substeps and after the adaptive span, with the same
    count: the collectives gather every shard's pieces in shard order and
    reduce them as the single controller does."""
    got = worker_outputs[1][backend][0]
    want = single_process[backend]
    assert int(got["k_adaptive"]) == want["k"]
    for f in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(got[f"{f}_fixed"],
                                      getattr(want["fixed"], f).numpy(), f)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want["final"], f).numpy(),
                                      f)
    np.testing.assert_array_equal(got["gm_src"], want["gm_src"].numpy())


def test_torch_run_matches_nbody_tpu(worker_outputs):
    """The "torch" run's state after the fixed substeps against nbody_tpu's
    ShardedWorld on its 8 virtual CPU devices ("jnp"), as
    tests/test_torch_sharding.py:95-113 holds the single-process world."""
    got = worker_outputs[1]["torch"][0]
    jw = jsh.ShardedWorld(
        nb.make_galaxies(worker.N, worker.GALAXIES, seed=worker.SEED),
        jsh.make_mesh(D), config=nb.SimConfig(**worker.CONFIG),
        force_backend="jnp")
    jw.update(worker.DT, worker.SUBSTEPS)
    want = jw.particles
    np.testing.assert_array_equal(got["mass_fixed"], np.asarray(want.mass))
    for name, tol in WORLD_TOL.items():
        err = rel_err(got[f"{name}_fixed"], getattr(want, name))
        assert err < tol, (name, err)


@pytest.mark.parametrize("backend", worker.BACKENDS)
def test_checkpoint_restores_on_one_process(worker_outputs, backend):
    """The npz checkpoint that rank 0 wrote from the 2-process world loads
    on a single-process 8-shard world, holds the gathered state and keeps
    running."""
    outdir, outputs = worker_outputs
    got = outputs[backend][0]
    w, step = load_world(str(outdir / f"{backend}_ckpt.npz"), ShardedWorld,
                         mesh=make_mesh(devices=["cpu"] * D),
                         force_backend=backend)
    assert step == worker.SUBSTEPS + int(got["k_adaptive"])
    assert w.config == _config()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(w.particles, f).numpy(), got[f])
    w.update(worker.DT, 1)
    assert torch.isfinite(w.particles.pos).all()


@pytest.mark.parametrize("backend", worker.BACKENDS)
def test_particles_refused_over_two_ranks(worker_outputs, backend):
    """ShardedWorld.particles on a world over 2 processes raises rather
    than hand back one rank's rows."""
    for out in worker_outputs[1][backend]:
        assert bool(out["particles_refused"])


@pytest.mark.parametrize("backend", worker.BACKENDS)
def test_single_process_multihost_world_is_sharded_world(backend):
    """Without a process group multihost_world is ShardedWorld on the same
    mesh: the same layout and the same bits."""
    assert not dist.is_initialized()
    mesh = make_mesh(devices=["cpu"] * worker.LOCAL)
    w = multihost.multihost_world(_scene(), mesh, config=_config(),
                                  force_backend=backend)
    ref = ShardedWorld(_scene(), mesh, config=_config(),
                       force_backend=backend)
    assert (w.s_loc, w.t_loc, w.src_len, w.n_pad) == \
        (ref.s_loc, ref.t_loc, ref.src_len, ref.n_pad)
    w.update(worker.DT, 3)
    ref.update(worker.DT, 3)
    got = multihost.gather_particles(w)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(ref.particles, f),
                                   rtol=0, atol=0)


@pytest.fixture
def group_of_one(tmp_path):
    """A Gloo process group of this one process, torn down after the
    test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", worker.BACKENDS + ("cuda",))
def test_group_of_one_runs_the_collectives(group_of_one, backend):
    """Over a group of one the world's collectives run through the group
    (the form [20] of chip_smoke.py runs under NCCL on one card): bit-equal
    to the single-process world, merging and adaptive included where the
    backend merges, gather_particles equal to particles."""
    mesh = make_mesh(devices=["cpu"] * worker.LOCAL)
    merge = backend != "p3m"
    cfg = nt.SimConfig(**worker.CONFIG, merge_collisions=merge)
    w = multihost.multihost_world(_scene(), mesh, config=cfg,
                                  force_backend=backend)
    assert w.group.pg is not None and w.group.size == 1
    ref = ShardedWorld(_scene(), mesh, config=cfg, force_backend=backend)
    w.update(worker.DT, 3)
    ref.update(worker.DT, 3)
    assert w.update_adaptive(worker.SPAN, dt_max=worker.DT_MAX) == \
        ref.update_adaptive(worker.SPAN, dt_max=worker.DT_MAX)
    got = multihost.gather_particles(w)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(ref.particles, f),
                                   rtol=0, atol=0)
        torch.testing.assert_close(getattr(w.particles, f), getattr(got, f),
                                   rtol=0, atol=0)
    torch.testing.assert_close(w.gm_src, ref.gm_src, rtol=0, atol=0)


def test_shard_group_refuses_the_wrong_backend(group_of_one, monkeypatch):
    """CPU shards over NCCL (and, by the same check, CUDA shards over Gloo)
    raise: no staging through the other backend, no silent switch."""
    monkeypatch.setattr(dist, "get_backend", lambda pg=None: "nccl")
    with pytest.raises(ValueError, match="needs a CPU backend"):
        multihost.multihost_world(_scene(), ["cpu"] * 2, config=_config())


def test_initialize_refuses_cpu_without_cpu_collectives():
    """initialize with CPU shards and no CPU collective backend raises, as
    does any backend that is not one; nothing is initialised."""
    for bad in (None, "nccl"):
        with pytest.raises(ValueError, match="CPU collective backend"):
            multihost.initialize("localhost:1", 2, 0, cpu_collectives=bad,
                                 device="cpu")
    assert not dist.is_initialized()


def test_initialize_needs_a_card_for_cuda():
    """The default shards are cards: without one, initialize raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 2, 0)
    assert not dist.is_initialized()


class _Group:
    def __init__(self, size):
        self.size = size


def test_mesh_chips_count_every_rank():
    """"auto"'s chips over a group: every shard on the CPU, the group's
    size times this rank's distinct cards on CUDA; so a world over ranks
    resolves as the single-process world with the same global D."""
    cpu, card = [torch.device("cpu")] * 4, [torch.device("cuda", 0)] * 4
    assert sh.mesh_chips(cpu, _Group(2)) == sh.mesh_chips(cpu * 2) == 8
    assert sh.mesh_chips(card, _Group(2)) == 2
    assert sh.mesh_chips([torch.device("cuda", 0), torch.device("cuda", 1)],
                         _Group(3)) == 6
    # 5.6e10 pairs: 7e9 a chip over 8 chips (the direct sum), 1.4e10 over
    # the 4 of one rank alone ("p3m")
    n, mass_len = 280_000, 200_000
    assert sh.resolve_force_backend("auto", cpu, n, mass_len) == "p3m"
    assert sh.resolve_force_backend("auto", cpu, n, mass_len,
                                    group=_Group(2)) == \
        sh.resolve_force_backend("auto", cpu * 2, n, mass_len) == "torch"
