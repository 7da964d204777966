"""The plan of the main-path pair loop (``ops/direct_forces.cluster_plan``):
P targets a thread and the source split of each target block, shared by the
direct kernel's ``fused_substep`` and ``force_acc`` and the ring hop
kernel's ``ring_hop``. Plans are plain integers, so they are checked here on
the CPU; the kernels that run them are held to their plain versions on the
card (``tests/test_torch_kernels.py``).

The ablation kernels keep the one-target-per-thread split of
``split_ranges`` and ``_split_plan``, whose results are pinned here too.
"""

import pytest
import torch
from torch_helpers import random_arrays, rel_err

import nbody_tpu_torch as nt
from nbody_tpu_torch.ops import direct_forces as df
from nbody_tpu_torch.ops import ring_forces as rf
from nbody_tpu_torch.parallel import ShardedWorld, make_mesh
from nbody_tpu_torch.parallel.sharding import shard_layout

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("t,s,t_real,max_split,want", [
    # N=65536 World: 128 blocks of 2 x 256 targets, 8 live warps each, fill
    # 132 SMs with 2 ranges of 65 and 64 runs
    (65_536, 32_833, None, 8, (2, 2)),
    # N=1M World: 2048 blocks fill the card
    (1 << 20, 524_704, None, 8, (2, 1)),
    # D=4 hops of N=65536 on one card, each planned for its shard's own
    # 16384 targets: 32 blocks, clusters of 5
    (16_384, 10_240, 16_384, 8, (2, 5)),
    (16_384, 2_113, 16_384, 8, (2, 5)),
    (16_384, 10_240, None, None, (2, 5)),
    # a shard with 12000 real targets of its 16384 rows: 24 blocks
    (16_384, 10_240, 12_000, 8, (2, 6)),
    # D=4 hops of N=1M on one card
    (262_144, 133_120, 262_144, 8, (2, 1)),
    # the P3M exact-core rows: 2 live warps a block, 4 blocks an SM; 513
    # ranges of 4 runs, through the scratch; at most a cluster of 8
    (64, 524_704, None, None, (1, 513)),
    (64, 524_704, None, 8, (1, 8)),
    # ragged T and S
    (1000, 333, None, 8, (2, 2)),
    (4096, 3000, None, None, (2, 12)),
    (4096, 3000, None, 8, (2, 6)),
    (300, 300, None, 8, (2, 2)),
    (100, 5000, None, 8, (1, 7)),
    (513, 256, None, 8, (2, 1)),     # one run: nothing to split
    (65_536, 0, None, 8, (2, 1)),    # no sources
])
def test_cluster_plan_at_the_main_path_shapes(t, s, t_real, max_split, want):
    plan = df.cluster_plan(t, s, SMS, t_real=t_real, max_split=max_split)
    assert plan == want
    assert plan.cluster == (plan.n_split if 1 < plan.n_split <= 8 else 1)


@pytest.mark.parametrize("sms", [132, 114, 78, 8])
def test_a_cluster_holds_at_most_eight_blocks_and_no_range_is_empty(sms):
    for t in (1, 64, 255, 256, 257, 700, 1000, 4096, 16_384, 65_536, 300_000):
        for s in (1, 255, 256, 257, 333, 2113, 3000, 32_833, 524_704):
            for t_real in (None, -(-t // 3)):
                plan = df.cluster_plan(t, s, sms, t_real=t_real,
                                       max_split=df.MAX_CLUSTER)
                runs = -(-s // df.RUN)
                per = -(-runs // plan.n_split)
                assert 1 <= plan.n_split <= df.MAX_CLUSTER
                # every range holds at least one run
                assert (plan.n_split - 1) * per < runs
                # uncapped, more ranges than a cluster go to the scratch
                free = df.cluster_plan(t, s, sms, t_real=t_real)
                assert free.n_split >= plan.n_split
                assert (free.cluster == 1) == (free.n_split == 1
                                               or free.n_split > 8)


@pytest.mark.parametrize("t,want", [(1, 1), (256, 1), (257, 2), (512, 2),
                                    (513, df.P_MAX), (65_536, df.P_MAX)])
def test_targets_per_thread(t, want):
    assert df.targets_per_thread(t) == want


@pytest.mark.parametrize("n,massive", [(700, 0.5), (2100, 1.0), (5000, 0.5),
                                       (65_536, 0.5), (1 << 20, 0.5)])
@pytest.mark.parametrize("sms", [132, 78])
def test_world_and_a_one_shard_ring_take_the_same_plan(n, massive, sms):
    """A D=1 ring pads its N targets and sources, but plans from the real
    ones as World does: the same plan, so the same bits."""
    mass_len = int(n * massive)
    s_loc, t_loc, _, _ = shard_layout(n, mass_len, nt.SimConfig(), 1)
    ring = rf.Ring(["cpu"], t_loc, s_loc, mass_len, [torch.zeros(s_loc)],
                   n_targets=n)
    world = df.cluster_plan(n, mass_len, sms, max_split=df.MAX_CLUSTER)
    hop = df.cluster_plan(t_loc, ring.n_real[0], sms, t_real=ring.t_real[0],
                          max_split=df.MAX_CLUSTER)
    assert ring.t_real[0] == n and ring.n_real[0] == mass_len
    assert hop == world


def test_ring_counts_the_real_targets_of_each_shard():
    p = nt.make_galaxies(2000, 2, seed=11037)
    w = ShardedWorld(p, make_mesh(devices=["cpu"] * 4), force_backend="cuda_ring")
    assert sum(w.ring.t_real) == 2000
    assert w.ring.t_real == [min(max(2000 - k * w.t_loc, 0), w.t_loc)
                             for k in range(4)]


@pytest.mark.parametrize("backend", ["cuda_ring", "cuda"])
@pytest.mark.parametrize("d", [2, 4])
def test_a_hop_is_planned_for_its_own_shard_alone(d, backend, monkeypatch):
    """Every hop of a D-shard ring is planned from its own shard's real
    targets, as a launch that has the card to itself, whatever the other
    shards on the card: the hop kernel ("cuda_ring") and the direct
    kernel's force_acc ("cuda") alike."""
    w = ShardedWorld(nt.make_galaxies(2000, 2, seed=11037),
                     make_mesh(devices=["cpu"] * d), force_backend=backend)
    module, name = (rf, "ring_hop") if backend == "cuda_ring" else (df, "force_acc")
    wrapper, seen = getattr(module, name), []

    def spy(tgt_pos, *a, t_real=None, **k):
        seen.append((tgt_pos.shape[0], t_real))
        return wrapper(tgt_pos, *a, t_real=t_real, **k)

    monkeypatch.setattr(module, name, spy)
    w.update(1.0, 1)
    assert seen == [(w.t_loc, w.ring.t_real[k]) for _ in range(d)
                    for k in range(d)]


@pytest.mark.parametrize("blocks,units,sms,want", [
    (1, 2050, 132, 257), (64, 129, 132, 5), (256, 129, 132, 2),
    (264, 129, 132, 1), (4, 12, 132, 12), (16, 33, 114, 11), (0, 5, 132, 1),
    (3, 1, 132, 1)])
def test_split_ranges_is_unchanged(blocks, units, sms, want):
    """The ablation kernels (ptile_forces, flavor_forces, bcast_probe) split
    by it."""
    assert df.split_ranges(blocks, units, sms) == want


@pytest.mark.parametrize("t,s,sms,want", [
    (64, 524_704, 132, 257), (1000, 333, 132, 2), (65_536, 32_833, 132, 2),
    (16_384, 8209, 132, 5), (512, 140_000, 78, 69), (4096, 3000, 132, 12)])
def test_split_plan_is_unchanged(t, s, sms, want):
    assert df._split_plan(t, s, sms) == want


@pytest.mark.parametrize("t,want", [(32, 1025), (64, 513), (128, 257),
                                    (256, 129)])
def test_few_targets_take_more_blocks_an_sm(t, want):
    """One block of T <= 256 targets has ceil(T/32) live warps; the split
    gives each SM LIVE_WARPS of them (S = 524704: 2050 runs)."""
    warps = -(-t // 32)
    plan = df.cluster_plan(t, 524_704, SMS)
    assert (plan.p, plan.n_split) == (1, want)
    # within the rounding of ranges to equal counts of whole runs
    assert plan.n_split * warps >= 0.95 * SMS * df.LIVE_WARPS


@pytest.mark.parametrize("plan", [(2, 16), (1, 300), (2, 3)])
def test_a_plan_on_cpu_tensors_takes_the_plain_version(plan):
    """On the CPU the wrappers take their plain versions whatever the plan."""
    pos, vel, mass, radius = (torch.from_numpy(a) for a in random_arrays(300, seed=3))
    gm = 10 * mass[:200].clamp(min=1.0)
    want = df.force_acc_plain(pos, radius, pos[:200], gm)
    assert torch.equal(df.force_acc(pos, radius, pos[:200], gm, plan=plan), want)
    got = df.fused_substep(0.01, pos, vel, radius, gm, plan=plan)
    assert rel_err(got[2], want) == 0.0
    run = torch.zeros_like(pos)
    rf.ring_hop(pos, radius, pos, gm, run, accumulate=False, plan=plan)
    assert torch.equal(run, want)


def test_plan_describes_its_cluster():
    assert df.Plan(2, 5).describe() == "P=2 n_split=5 cluster=5 chunk=2048"
    assert df.Plan(1, 257).describe() == ("P=1 n_split=257 cluster=1 "
                                          "chunk=2048 (scratch reduce)")
    assert df.Plan(2, 1).cluster == 1


@pytest.mark.parametrize("plan", [(4, 1), (3, 2), (0, 1), (2, 0)])
def test_a_forced_plan_takes_p_1_or_2(plan):
    """The kernels are built for P = 1 and 2 only."""
    with pytest.raises(ValueError, match="p in"):
        df._checked_plan(plan)
    assert df._checked_plan((2, 8)) == df.Plan(2, 8)
