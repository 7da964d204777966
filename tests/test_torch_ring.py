"""The ring of the port's sharded world on the CPU: its schedule checked as
data, the executor and the hop wrapper against their plain versions, the
plain ring substep against nbody_tpu's Pallas ring kernel (interpret
mode), and copies of tests/test_ring_kernel.py."""

from types import SimpleNamespace

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import random_arrays, rel_err

import nbody_tpu_torch as nt
from nbody_tpu.ops.ring_forces import ring_substep as jax_ring_substep
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.parallel.sharding import padded_state, shard_layout

TINY = nt.SimConfig(tile_targets=8, tile_sources=128)
# the port's force tolerance (tests/test_torch_forces.py:5)
FORCE_TOL = 1e-6


def _particles(n, seed=0, massless_frac=0.3):
    pos, vel, mass, radius = random_arrays(n, seed=seed,
                                           massless_frac=massless_frac)
    return nt.make_particles(pos, vel=vel, mass=mass, radius=radius)


def _cpu_mesh(d):
    return make_mesh(devices=["cpu"] * d)


# --- the schedule, as data ---

def _passes(d, n=2):
    """n passes of the schedule, each after the ("ready", k) events the
    caller records on every compute stream."""
    seq = []
    for _ in range(n):
        seq += [SimpleNamespace(key=("ready", k), stream=("compute", k),
                                waits=(), reads=(), writes=())
                for k in range(d)]
        seq += rf.ring_schedule(d)
    return seq


def _happens_before(seq):
    """For each operation, the set of earlier operations ordered before it
    on the device: by program order on its stream, and through the events
    it waits for (the last record of each, in host order)."""
    before, last_on, last_rec = [], {}, {}
    for i, op in enumerate(seq):
        p = set()
        if op.stream in last_on:
            j = last_on[op.stream]
            p |= {j} | before[j]
        for key in op.waits:
            assert key in last_rec, f"{op.key} waits for {key}, not yet recorded"
            j = last_rec[key]
            p |= {j} | before[j]
        before.append(p)
        last_on[op.stream] = i
        last_rec[op.key] = i
    return before


@pytest.mark.parametrize("d", range(1, 9))
def test_ring_schedule_is_race_free(d):
    """Over two passes: every write of a slot is ordered after every earlier
    read and write of it (no copy into a slot starts before the neighbour's
    compute and send that last read it), and every read after the write
    that filled the slot (each compute waits for its copy)."""
    seq = _passes(d)
    before = _happens_before(seq)
    for j, op in enumerate(seq):
        for i in range(j):
            prev = seq[i]
            clash = (set(op.writes) & (set(prev.reads) | set(prev.writes))
                     or set(op.reads) & set(prev.writes))
            if clash:
                assert i in before[j], (prev.key, op.key, clash)


@pytest.mark.parametrize("d", range(1, 9))
def test_ring_schedule_shape(d):
    ops = rf.ring_schedule(d)
    computes = [op for op in ops if op.kind == "compute"]
    assert len(computes) == d * d
    assert sum(op.kind == "send" for op in ops) == d * (d - 1)
    assert sum(op.kind == "gather" for op in ops) == d
    # the epilogue rides the last hop, once per shard
    assert [op.hop for op in computes if op.last] == [d - 1] * d
    # each shard meets every source shard once: slot h % 2 holds shard
    # (s - h) mod D, carried there by the sends
    holder = {}
    for op in ops:
        if op.kind == "gather":
            holder[(op.shard, 0)] = op.shard
        elif op.kind == "send":
            holder[op.writes[0]] = holder[op.reads[0]]
        else:
            assert holder[op.reads[0]] == (op.shard - op.hop) % d
    for s in range(d):
        seen = sorted((s - op.hop) % d for op in computes if op.shard == s)
        assert seen == list(range(d))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_gather_fills_slot_with_source_rows(d):
    """Slot 0 of shard k holds rows [k·s_loc, k·s_loc + n_real) of the global
    padded positions, wherever they lie, and their gm."""
    p = _particles(300, seed=d, massless_frac=0.2)
    sw = ShardedWorld(p, _cpu_mesh(d), config=TINY)
    full_pos = torch.cat(sw.pos)
    ring = sw.ring
    gathers = [op for op in ring.schedule if op.kind == "gather"]
    for k, op in enumerate(gathers):
        assert op.shard == k
        ring._gather(op, sw.pos)
        n = ring.n_real[k]
        spos, sgm = ring.slot(k, 0)
        lo = k * sw.s_loc
        assert torch.equal(spos[:n], full_pos[lo:lo + n])
        assert torch.equal(sgm[:n], sw.gm_src[lo:lo + n])
    assert sum(ring.n_real) == sw.mass_len


def test_source_pieces_cross_target_shards():
    # N=65536 on 4 shards: s_loc 10240, t_loc 16384; shard 1's rows
    # 10240-20479 cross from target shard 0 into target shard 1
    s_loc, t_loc, _, _ = shard_layout(65536, 32833, nt.SimConfig(), 4)
    assert (s_loc, t_loc) == (10240, 16384)
    assert rf.source_pieces(1, s_loc, t_loc, s_loc) == [
        (0, 10240, 16384, 0), (1, 0, 4096, 6144)]
    assert rf.source_pieces(3, s_loc, t_loc, 2113) == [(1, 14336, 16384, 0),
                                                       (2, 0, 65, 2048)]
    assert rf.source_pieces(2, s_loc, t_loc, 0) == []


# --- the hop wrapper and the executor against their plain versions ---

def _shards(d, t, seed=0):
    """Per-shard random targets: positions, velocities, radii and a valid
    row with about 10% padding."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32))

    pos = [f32(100 * rng.normal(size=(t, 2))) for _ in range(d)]
    vel = [f32(rng.normal(size=(t, 2))) for _ in range(d)]
    radius = [f32(rng.uniform(0.5, 9.5, t)) for _ in range(d)]
    valid = [f32(rng.uniform(size=t) < 0.9) for _ in range(d)]
    return pos, vel, radius, valid


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("pos_dt", [1.0, 0.5])
def test_ring_hop_matches_plain(precise, pos_dt):
    """On CPU tensors the wrapper is its plain version: in place and
    accumulating below the last hop, the masked epilogue at it."""
    pos, vel, radius, valid = _shards(1, 40, seed=7)
    src_pos, src_gm = pos[0][:33], torch.linspace(10, 1e5, 33)
    acc_a, acc_b = torch.zeros(40, 2), torch.zeros(40, 2)
    for accumulate in (False, True):
        assert rf.ring_hop(pos[0], radius[0], src_pos, src_gm, acc_a,
                           accumulate=accumulate, precise=precise) is None
        rf.ring_hop_plain(pos[0], radius[0], src_pos, src_gm, acc_b,
                          accumulate=accumulate, precise=precise)
        assert torch.equal(acc_a, acc_b)
    once = nt.direct_sum_acc(pos[0], radius[0], src_pos, src_gm, precise=precise)
    torch.testing.assert_close(acc_a, 2 * once, rtol=1e-6, atol=0)
    kw = dict(accumulate=True, precise=precise, vel=vel[0], valid=valid[0],
              dt=0.01, pos_dt=pos_dt)
    got = rf.ring_hop(pos[0], radius[0], src_pos, src_gm, acc_a, **kw)
    want = rf.ring_hop_plain(pos[0], radius[0], src_pos, src_gm, acc_b, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    masked = valid[0] == 0
    assert torch.equal(got[2][masked], torch.zeros_like(got[2][masked]))
    assert torch.equal(acc_a, acc_b)  # the last hop leaves acc_run as it was


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_ring_substep_matches_plain(d):
    """The executor (gather, slots, sends, the hop wrapper) against the
    plain ring that reads each shard's sources directly, with ragged real
    source counts (40 of 16 rows per shard: 16, 16, 8, 0)."""
    t_loc, s_loc = 24, 16
    mass_len = min(40, d * s_loc)
    pos, vel, radius, valid = _shards(d, t_loc, seed=d)
    gm = torch.from_numpy(np.where(np.arange(d * s_loc) < mass_len,
                                   np.linspace(10, 1e5, d * s_loc), 0)
                          .astype(np.float32))
    gm_src = list(gm.split(s_loc))
    ring = rf.Ring(["cpu"] * d, t_loc, s_loc, mass_len, gm_src)
    got = rf.ring_substep(ring, 0.01, pos, vel, radius, valid, pos_dt=0.5)
    full = torch.cat(pos)
    n = ring.n_real
    assert n == [min(max(mass_len - k * s_loc, 0), s_loc) for k in range(d)]
    want = rf.ring_substep_plain(
        0.01, pos, vel, radius, valid,
        [full[k * s_loc:k * s_loc + n[k]] for k in range(d)],
        [gm_src[k][:n[k]] for k in range(d)], pos_dt=0.5)
    for x, y in zip(got, want):
        for k in range(d):
            assert rel_err(x[k], y[k]) < FORCE_TOL


@pytest.mark.parametrize("precise", [False, True])
@pytest.mark.parametrize("stream_sources", [False, True])
def test_ring_substep_plain_matches_nbody_tpu(stream_sources, precise):
    """nbody_tpu's fused ring kernel on one device (interpret mode), on the
    inputs of tests/test_ring_kernel.py::test_streaming_sources_mode."""
    rng = np.random.default_rng(53)
    t_loc, s_loc = 16, 128
    pos = rng.normal(size=(t_loc, 2)).astype(np.float32) * 50
    vel = rng.normal(size=(t_loc, 2)).astype(np.float32)
    radius = rng.uniform(0.5, 5.0, t_loc).astype(np.float32)
    valid = np.ones((t_loc, 1), np.float32)
    src = np.zeros((3, s_loc), np.float32)
    src[0] = rng.normal(size=s_loc) * 50
    src[1] = rng.normal(size=s_loc) * 50
    src[2, :40] = rng.uniform(10, 100, 40)
    want = jax_ring_substep(
        jnp.float32(0.01), *(jnp.asarray(a) for a in (pos, vel, radius, valid, src)),
        axis=None, n_devices=1, tile_t=8, tile_s=128, precise=precise,
        stream_sources=stream_sources)
    t = torch.from_numpy
    got = rf.ring_substep_plain(
        0.01, [t(pos)], [t(vel)], [t(radius)], [t(valid[:, 0])],
        [t(np.ascontiguousarray(src[:2].T))], [t(src[2])], precise=precise)
    for x, y in zip(got, want):
        assert rel_err(x[0], np.asarray(y)) < FORCE_TOL


# --- copies of tests/test_ring_kernel.py ("pallas_ring" -> "cuda_ring") ---

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
def test_fused_ring_matches_single_device(n_devices):
    p = _particles(64, seed=41)
    sw = ShardedWorld(p, _cpu_mesh(n_devices), config=TINY,
                      force_backend="cuda_ring")
    w = nt.create_world(p, config=TINY, device="cpu")
    sw.update(0.01, 3)
    w.update(0.01, 3, backend="torch")
    for name in ("pos", "vel"):
        np.testing.assert_allclose(getattr(sw.particles, name).numpy(),
                                   getattr(w.particles, name).numpy(),
                                   rtol=3e-4, atol=3e-3)


def test_fused_ring_matches_xla_ring():
    p = _particles(96, seed=43)
    a = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="cuda_ring")
    b = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="torch")
    a.update(0.02, 2)
    b.update(0.02, 2)
    np.testing.assert_allclose(a.particles.pos.numpy(), b.particles.pos.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_fused_ring_massless_and_finite():
    p = _particles(64, seed=47, massless_frac=0.7)
    sw = ShardedWorld(p, _cpu_mesh(2), config=TINY, force_backend="cuda_ring")
    sw.update(0.01, 2)
    host = sw.particles
    assert torch.isfinite(host.pos).all()
    assert (host.acc != 0).any()


def test_all_massless_ring_drifts():
    """mass_len == 0: every shard has no real source, every hop still runs
    (the last carries the drift), and the world drifts back exactly."""
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(40, 2)).astype(np.float32)
    vel = rng.normal(size=(40, 2)).astype(np.float32)
    p = nt.make_particles(pos, vel=vel, radius=np.zeros(40, np.float32))
    sw = ShardedWorld(p, _cpu_mesh(3), config=TINY, force_backend="cuda_ring")
    assert sw.ring.n_real == [0, 0, 0]
    sw.update(0.01, 5)
    sw.update(-0.01, 5)
    np.testing.assert_allclose(sw.particles.pos.numpy(), pos, atol=2e-6)
    assert torch.equal(sw.particles.acc, torch.zeros(40, 2))


def test_padded_state_feeds_every_backend_the_same_sources():
    """The ring over 4 CPU shards gives each target the force of all
    mass_len sources: one Euler substep against the direct sum on the
    padded state."""
    p = _particles(130, seed=9)
    sw = ShardedWorld(p, _cpu_mesh(4), config=TINY, force_backend="cuda_ring")
    state, gm, _ = padded_state(p, sw.mass_len, sw.n_pad, 10.0)
    want = nt.direct_sum_acc(state.pos[:130], state.radius[:130],
                             state.pos[:sw.mass_len], gm[:sw.mass_len],
                             precise=False)
    sw.update(0.01, 1)
    assert rel_err(sw.particles.acc, want) < FORCE_TOL
