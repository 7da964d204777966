"""Direct-sum force and fused substep: the CUDA kernel's wrappers, each with
its plain PyTorch version beside it.

Counterparts of ``fused_substep`` and ``pallas_acc`` in
``nbody_tpu/ops/pallas_forces.py``. One kernel, ``csrc/direct_forces.cu``,
replaces both TPU kernels there (``_substep_kernel`` with resident sources
and ``_stream_kernel`` with streamed ones): it stages sources through shared
memory chunk by chunk, masks its own ragged edges, and reads sources straight
from ``pos[:S]`` and ``gm``.

Every launch of the direct kernel and of the ring hop kernel
(``ops/ring_forces.ring_hop``) takes its plan from :func:`cluster_plan`: P
targets a thread and the number of blocks that split each target block's
source sum, as one thread-block cluster of at most 8 blocks. Only
``force_acc`` with few targets against many sources needs more ranges than
a cluster holds; it then writes partials to a scratch that a second kernel
sums in range order. Either way a call counts as one launch.

``force_acc`` is differentiable: a ``torch.autograd.Function`` whose
forward is the launch above and whose backward is :func:`force_acc_vjp`,
the VJP of the direct sum with respect to all four inputs, recomputed from
the saved inputs (O(N) residuals, no O(T·S) ones), as
``make_differentiable_acc`` in ``nbody_tpu/ops/pallas_forces.py`` does. On
the card that VJP is one pass of ``csrc/direct_vjp.cu`` over the pairs;
on the CPU its plain version, :func:`force_acc_vjp_plain`.

Dispatch is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, and anything wrong there raises.
Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from .. import forces

# The kernel's threads per block, and the sources per shared-memory tile of
# the one-target-per-thread split that ``_split_plan`` plans for the
# ablation kernels (csrc/source_tiles.cuh kBlock).
BLOCK = 256
TILE = 256
# The main-path pair loop (csrc/direct_tiles.cuh): sources per run (summed
# into fresh registers), sources staged per chunk (its kChunk), the most
# targets a thread, and the portable cluster size. P_MAX and CHUNK were
# chosen by a sweep on an H100
# (``python -m nbody_tpu_torch.ablations.tune_direct sweep``).
RUN = 256
CHUNK = 2048
P_MAX = 2
MAX_CLUSTER = 8
# Warps with real targets that an SM needs to keep its issue busy: one
# block of 256 threads at P = 2 per SM ran within 1% of two, more blocks
# of few live warps ran faster (PERF.md, the sweep).
LIVE_WARPS = 8

# Kernel launches made by the wrappers in this process (plain-version calls
# are not counted). A run resets it to 0 and reads it back to show which
# path it took.
LAUNCHES = 0
# The plan of each of those launches, counted ({Plan: launches}).
PLANS: Counter = Counter()
# Kernel launches of the VJP (csrc/direct_vjp.cu): each call of
# ``force_acc_vjp`` on the card makes one pass over the pairs and adds 1
# (the fixed-order sums of its partials are part of it).
VJP_LAUNCHES = 0
# Blocks of the VJP kernel an SM holds (its __launch_bounds__), and the
# most own rows a thread holds (each batch's reduction over the warp is
# shared by P of them).
VJP_BLOCKS_PER_SM = 2
VJP_P_MAX = 4


class VjpPlan(NamedTuple):
    """How a launch of the VJP kernel cuts its work: the ``own`` side
    ("targets" or "sources") sits in registers, ``p`` rows a thread (1, 2
    or 4), in tiles of ``p`` · 256 rows; the other side is cut into ``n_split``
    ranges of ``runs_per_split`` whole runs of 256 rows (the last range may
    be shorter). A block is one (tile, range)."""

    own: str
    p: int
    n_split: int
    runs_per_split: int

    def describe(self) -> str:
        return (f"own={self.own} P={self.p} n_split={self.n_split} "
                f"({self.runs_per_split} runs a range)")


class Plan(NamedTuple):
    """How a launch of the direct or ring hop kernel cuts its work: ``p``
    targets a thread, ``n_split`` blocks per target block (each a range of
    whole runs of the sources)."""

    p: int
    n_split: int

    @property
    def cluster(self) -> int:
        """Blocks of a cluster: ``n_split`` when the ranges are reduced in
        a cluster, 1 when there is no split or a scratch reduce."""
        return self.n_split if 1 < self.n_split <= MAX_CLUSTER else 1

    def describe(self) -> str:
        scratch = self.n_split > 1 and self.cluster == 1
        return (f"P={self.p} n_split={self.n_split} cluster={self.cluster} "
                f"chunk={CHUNK}{' (scratch reduce)' if scratch else ''}")


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned for the kernel")


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"direct_forces runs on CPU (plain version) or CUDA (kernel) "
            f"tensors, got {t.device}")
    return t.device


def _kernel_args(tgt_pos, tgt_vel, tgt_radius, src_pos, src_gm, dt, pos_dt,
                 precise, acc, pos_out, vel_out, plan: Plan,
                 partial=None) -> tuple:
    """Arguments of the C entry point ``nbody_direct_forces``, stream aside.
    The source count is len(src_gm): ``src_pos`` may hold more rows (the
    fused substep passes all of ``pos`` and reads its first S rows)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    return (tgt_pos.data_ptr(), ptr(tgt_vel), tgt_radius.data_ptr(),
            src_pos.data_ptr(), src_gm.data_ptr(),
            tgt_pos.shape[0], src_gm.shape[0], float(dt), float(pos_dt),
            int(precise), int(pos_out is not None),
            plan.p, plan.n_split, ptr(partial),
            acc.data_ptr(), ptr(pos_out), ptr(vel_out))


def _lib():
    from . import _build

    return _build.load("direct_forces")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch(*args, plan: Plan, partial=None) -> None:
    """Launch the kernel on the current stream of the targets' device with
    the arguments of :func:`_kernel_args` and ``plan``; raise if the launch
    failed."""
    global LAUNCHES
    with torch.cuda.device(args[0].device):
        err = _lib().nbody_direct_forces(
            *_kernel_args(*args, plan, partial),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "direct_forces")
    LAUNCHES += 1
    PLANS[plan] += 1


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``
    (cudaDeviceGetAttribute, read once per device)."""
    import ctypes

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().nbody_sm_count(ctypes.addressof(out)), "sm count")
    return out.value


def device_sms(device: torch.device) -> int:
    """:func:`sm_count` of a CUDA device (its index, or the current one)."""
    return sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())


def split_ranges(blocks: int, units: int, sms: int) -> int:
    """Number of contiguous source ranges of whole units (tiles, chunks)
    for ``blocks`` target blocks on a card of ``sms`` SMs: 1 when the
    target blocks fill two blocks per SM; else enough ranges for about two
    blocks per SM, with no range left empty."""
    if blocks == 0 or units <= 1 or blocks >= 2 * sms:
        return 1
    n = min(-(-2 * sms // blocks), units)
    per = -(-units // n)
    return -(-units // per)


def _split_plan(t: int, s: int, sms: int) -> int:
    """Number of source ranges for T targets, one a thread, against S
    sources on a card of ``sms`` SMs (:func:`split_ranges` over blocks of
    256 targets and tiles of 256 sources): the split of the kernels of
    one target a thread (``csrc/ptile_forces.cu`` takes it)."""
    return split_ranges(-(-t // BLOCK), -(-s // TILE), sms)


def targets_per_thread(t: int) -> int:
    """P for T targets: 1 up to one row of a block (256), else P_MAX. A
    ring of one shard pads N targets to a count on the same side of 256,
    so it takes World's P."""
    return 1 if t <= BLOCK else P_MAX


def cluster_plan(t: int, s: int, sms: int, *, t_real: int | None = None,
                 max_split: int | None = None) -> Plan:
    """The plan of a direct or ring hop launch of T targets against S
    sources on a card of ``sms`` SMs.

    P = :func:`targets_per_thread` of T. ``t_real`` is the number of real
    targets among the T (a ring's shard pads its targets; T by default),
    in blocks of P·256. The source sum is split over n ranges of whole runs
    of 256 so that the blocks give every SM ``LIVE_WARPS`` warps with real
    targets (a block has 8, or fewer when ``t_real`` is under 256), at most
    one range a run and ``max_split`` ranges (``MAX_CLUSTER`` for the
    kernels that can only reduce in a cluster), with no range left empty.
    A launch is planned alone, as if it had the card to itself: the D hops
    of a ring's shards on one card are enqueued on their own streams, but
    the host enqueues them slowly enough that they often run one at a
    time."""
    p = targets_per_thread(t)
    f = t if t_real is None else t_real
    blocks = -(-f // (p * BLOCK))
    runs = -(-s // RUN)
    if blocks == 0 or runs <= 1:
        return Plan(p, 1)
    warps = min(BLOCK // 32, -(-f // 32))
    want = sms * -(-LIVE_WARPS // warps)
    n = min(-(-want // blocks), runs)
    if max_split is not None:
        n = min(n, max_split)
    per = -(-runs // n)
    return Plan(p, -(-runs // per))


def _checked_plan(plan) -> Plan:
    plan = Plan(*plan)
    if plan.p not in (1, 2) or plan.n_split < 1:
        raise ValueError(f"a plan takes p in (1, 2) and n_split >= 1, got "
                         f"{plan}")
    return plan


def force_acc_plain(tgt_pos, tgt_radius, src_pos, src_gm, *,
                    precise: bool = False) -> torch.Tensor:
    """Plain version of :func:`force_acc`."""
    return forces.direct_sum_acc(tgt_pos, tgt_radius, src_pos, src_gm,
                                 precise=precise)


def force_acc(
    tgt_pos: torch.Tensor,     # (T, 2)
    tgt_radius: torch.Tensor,  # (T,)
    src_pos: torch.Tensor,     # (S, 2)
    src_gm: torch.Tensor,      # (S,) G * mass
    *,
    precise: bool = False,
    t_real: int | None = None,
    plan: tuple | None = None,
) -> torch.Tensor:
    """(T, 2) fp32 accelerations of every target from all S sources (the
    ``pallas_acc`` counterpart). Any T and S, S = 0 included. On the card
    the launch follows :func:`cluster_plan` (``t_real``: the real targets
    among the T, all of them by default), or ``plan`` (p, n_split) where
    given; more than ``MAX_CLUSTER`` ranges go through a scratch and a
    second kernel. Either way it counts as one launch. Differentiable with
    respect to the four tensors: the backward is :func:`force_acc_vjp`."""
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src_pos.shape[0]
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src_pos", src_pos, (s, 2), device)
    _check("src_gm", src_gm, (s,), device)
    return _ForceAcc.apply(tgt_pos, tgt_radius, src_pos, src_gm, precise,
                           t_real, plan)


def _force_acc(tgt_pos, tgt_radius, src_pos, src_gm, precise, t_real,
               plan) -> torch.Tensor:
    """:func:`force_acc`'s forward on checked inputs."""
    device = tgt_pos.device
    if device.type == "cpu":
        return force_acc_plain(tgt_pos, tgt_radius, src_pos, src_gm,
                               precise=precise)
    t, s = tgt_pos.shape[0], src_pos.shape[0]
    plan = (cluster_plan(t, s, device_sms(device), t_real=t_real)
            if plan is None else _checked_plan(plan))
    acc = torch.empty((t, 2), dtype=torch.float32, device=device)
    partial = None
    if plan.n_split > MAX_CLUSTER:
        partial = torch.empty((plan.n_split, t, 2), dtype=torch.float32,
                              device=device)
    _launch(tgt_pos, None, tgt_radius, src_pos, src_gm, 0.0, 1.0, precise,
            acc, None, None, plan=plan, partial=partial)
    return acc


class _ForceAcc(torch.autograd.Function):
    """:func:`force_acc` with its VJP: only the four inputs are saved, and
    the backward recomputes the pair terms (:func:`force_acc_vjp`)."""

    @staticmethod
    def forward(ctx, tgt_pos, tgt_radius, src_pos, src_gm, precise, t_real,
                plan):
        ctx.save_for_backward(tgt_pos, tgt_radius, src_pos, src_gm)
        ctx.precise = precise
        return _force_acc(tgt_pos, tgt_radius, src_pos, src_gm, precise,
                          t_real, plan)

    @staticmethod
    def backward(ctx, g):
        grads = force_acc_vjp(*ctx.saved_tensors, g.contiguous(),
                              precise=ctx.precise)
        return (*grads, None, None, None)


def force_acc_vjp_plain(tgt_pos, tgt_radius, src_pos, src_gm, g, *,
                        precise: bool = False, chunk: int | None = None):
    """Plain version of :func:`force_acc_vjp`: the explicit VJP, a chunk of
    ``chunk`` targets at a time (by default the chunk of
    ``forces.direct_sum_acc``), so memory is O(chunk · S). The source
    cotangents are summed chunk by chunk in target order. The results
    take the inputs' dtype (float64 inputs give a float64 reference)."""
    t, s = tgt_pos.shape[0], src_pos.shape[0]
    like = dict(dtype=tgt_pos.dtype, device=tgt_pos.device)
    d_tp, d_sp = torch.zeros((t, 2), **like), torch.zeros((s, 2), **like)
    d_tr, d_sg = torch.zeros((t,), **like), torch.zeros((s,), **like)
    if t == 0 or s == 0:
        return d_tp, d_tr, d_sp, d_sg
    if chunk is None:
        chunk = max(1, forces.CHUNK_ELEMS // s)
    with torch.no_grad():
        for i in range(0, t, chunk):
            tp, gg = tgt_pos[i:i + chunk], g[i:i + chunk]
            dx = src_pos[None, :, 0] - tp[:, None, 0]
            dy = src_pos[None, :, 1] - tp[:, None, 1]
            r2 = dx * dx + dy * dy + (tgt_radius[i:i + chunk]
                                      + forces.SOFTENING_FLOOR)[:, None]
            if precise:
                k = 1.0 / (forces.sqrt(r2) * r2)
            else:
                inv = torch.rsqrt(r2)
                k = inv * inv * inv
            f = src_gm[None, :] * k
            gx, gy = gg[:, 0:1], gg[:, 1:2]
            sdot = gx * dx + gy * dy
            e = -1.5 * f * sdot / r2
            e2 = 2.0 * e
            cx = f * gx + e2 * dx
            cy = f * gy + e2 * dy
            d_tp[i:i + chunk] = -torch.stack([cx.sum(1), cy.sum(1)], -1)
            d_tr[i:i + chunk] = e.sum(1)
            d_sp += torch.stack([cx.sum(0), cy.sum(0)], -1)
            d_sg += (k * sdot).sum(0)
    return d_tp, d_tr, d_sp, d_sg


def vjp_plan(t: int, s: int, sms: int) -> VjpPlan:
    """The plan of the VJP kernel for T targets and S sources on a card of
    ``sms`` SMs, from shapes alone, so that a recomputed backward repeats
    its bits. The own side is the larger (targets on ties); P is the
    smallest of 1, 2, VJP_P_MAX whose one tile holds the own rows, else
    VJP_P_MAX; its tiles times the ranges make about one wave of
    VJP_BLOCKS_PER_SM blocks an SM, and no range is empty."""
    own_targets = t >= s
    n_own, n_other = (t, s) if own_targets else (s, t)
    p = next(p for p in (1, 2, VJP_P_MAX)
             if n_own <= p * BLOCK or p == VJP_P_MAX)
    tiles = -(-n_own // (p * BLOCK))
    runs = -(-n_other // RUN)
    n = max(1, min(runs, VJP_BLOCKS_PER_SM * sms // max(tiles, 1)))
    n = -(-runs // -(-runs // n)) if runs else 1   # no empty range
    # the kernel's own runs a range (csrc/direct_vjp.cu)
    return VjpPlan("targets" if own_targets else "sources", p, n,
                   max(1, -(-runs // n)))


def vjp_blocks(t: int, s: int, plan: VjpPlan) -> list:
    """The (own rows, other rows) ranges of each block of a launch with
    ``plan``, in block order (the kernel's own arithmetic): tile k holds
    own rows [k·P·256, (k+1)·P·256) ∩ [0, n_own), range r other rows
    [r·R·256, (r+1)·R·256) ∩ [0, n_other), R = runs_per_split."""
    n_own, n_other = (t, s) if plan.own == "targets" else (s, t)
    size, span = plan.p * BLOCK, plan.runs_per_split * RUN
    return [((k * size, min((k + 1) * size, n_own)),
             (min(r * span, n_other), min((r + 1) * span, n_other)))
            for k in range(-(-n_own // size)) for r in range(plan.n_split)]


def force_acc_vjp(
    tgt_pos: torch.Tensor,     # (T, 2)
    tgt_radius: torch.Tensor,  # (T,)
    src_pos: torch.Tensor,     # (S, 2)
    src_gm: torch.Tensor,      # (S,)
    g: torch.Tensor,           # (T, 2) cotangent of force_acc's result
    *,
    precise: bool = False,
):
    """The VJP of :func:`force_acc` at its inputs with cotangent ``g``:
    (d_tgt_pos (T, 2), d_tgt_radius (T,), d_src_pos (S, 2), d_src_gm (S,)).

    With d = p_j − p_i, r2 = |d|² + r_i + SOFTENING_FLOOR, k = r2^(−3/2)
    (precise: 1 / (sqrt(r2)·r2); else rsqrt cubed), f = gm_j·k,
    s = g_i·d and e = −1.5·f·s / r2:
    d_tgt_pos_i = −Σ_j (f·g_i + 2e·d), d_src_pos_j = Σ_i (f·g_i + 2e·d),
    d_tgt_radius_i = Σ_j e, d_src_gm_j = Σ_i k·s.

    On the card: one pass of ``csrc/direct_vjp.cu`` over the pairs, cut
    as :func:`vjp_plan` says, and its partials summed in a fixed order, no
    atomics. On the CPU: :func:`force_acc_vjp_plain`."""
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src_pos.shape[0]
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src_pos", src_pos, (s, 2), device)
    _check("src_gm", src_gm, (s,), device)
    _check("g", g, (t, 2), device)
    if device.type == "cpu":
        return force_acc_vjp_plain(tgt_pos, tgt_radius, src_pos, src_gm, g,
                                   precise=precise)
    global VJP_LAUNCHES
    f32 = dict(dtype=torch.float32, device=device)
    d_tp, d_sp = torch.zeros((t, 2), **f32), torch.zeros((s, 2), **f32)
    d_tr, d_sg = torch.zeros((t,), **f32), torch.zeros((s,), **f32)
    if t == 0 or s == 0:
        return d_tp, d_tr, d_sp, d_sg
    plan = vjp_plan(t, s, device_sms(device))
    n_own, n_other = (t, s) if plan.own == "targets" else (s, t)
    tiles = -(-n_own // (plan.p * BLOCK))
    # (tiles, 3, other rows) partials of the other side; (ranges, 3, own
    # rows) of the own side when it is split
    other_part = torch.empty((tiles, 3, n_other), **f32)
    own_part = (torch.empty((plan.n_split, 3, n_own), **f32)
                if plan.n_split > 1 else None)
    with torch.cuda.device(device):
        _raise_on(_vjp_lib().nbody_direct_vjp(
            tgt_pos.data_ptr(), tgt_radius.data_ptr(), src_pos.data_ptr(),
            src_gm.data_ptr(), g.data_ptr(), t, s, int(precise),
            int(plan.own == "targets"), plan.p, plan.n_split,
            None if own_part is None else own_part.data_ptr(),
            other_part.data_ptr(), d_tp.data_ptr(), d_tr.data_ptr(),
            d_sp.data_ptr(), d_sg.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "direct_vjp")
    VJP_LAUNCHES += 1
    return d_tp, d_tr, d_sp, d_sg


def _vjp_lib():
    from . import _build

    return _build.load("direct_vjp")


def _pos_dt_times_dt(pos_dt: float, dt: float) -> float:
    """pos_dt * dt rounded as the kernel (and _finalize) form it: in fp32."""
    return float(np.float32(pos_dt) * np.float32(dt))


def fused_substep_plain(dt, pos, vel, radius, gm, *, precise: bool = False,
                        pos_dt: float = 1.0):
    """Plain version of :func:`fused_substep`."""
    acc = forces.direct_sum_acc(pos, radius, pos[:gm.shape[0]], gm,
                                precise=precise)
    nvel = vel + dt * acc
    npos = pos + _pos_dt_times_dt(pos_dt, dt) * nvel
    return npos, nvel, acc


def fused_substep(
    dt: float,
    pos: torch.Tensor,     # (N, 2); sources are pos[:S]
    vel: torch.Tensor,     # (N, 2)
    radius: torch.Tensor,  # (N,)
    gm: torch.Tensor,      # (S,) G * mass of the massive prefix, S <= N
    *,
    precise: bool = False,
    pos_dt: float = 1.0,
    plan: tuple | None = None,
):
    """One substep, force and integration, in one kernel launch (the
    ``fused_substep`` counterpart).

    Sources are the first S = len(gm) rows of ``pos``. ``pos_dt=1.0`` is
    the reference's semi-implicit Euler (v += a*dt; x += v*dt); ``0.5`` is
    the kick and half-drift of a DKD stage. ``dt`` is a Python float, so
    the call makes no host sync. The launch follows :func:`cluster_plan`
    with at most ``MAX_CLUSTER`` ranges, or ``plan`` (p, n_split) where
    given; a split of more than the card's cluster size is refused
    and raises. Returns new (pos, vel, acc), each (N, 2), in fresh buffers:
    the inputs are not modified.
    """
    device = _device_of(pos)
    n, s = pos.shape[0], gm.shape[0]
    if s > n:
        raise ValueError(f"gm has {s} sources but pos only {n} rows")
    _check("pos", pos, (n, 2), device)
    _check("vel", vel, (n, 2), device)
    _check("radius", radius, (n,), device)
    _check("gm", gm, (s,), device)
    if device.type == "cpu":
        return fused_substep_plain(dt, pos, vel, radius, gm, precise=precise,
                                   pos_dt=pos_dt)
    plan = (cluster_plan(n, s, device_sms(device), max_split=MAX_CLUSTER)
            if plan is None else _checked_plan(plan))
    acc = torch.empty((n, 2), dtype=torch.float32, device=device)
    npos = torch.empty_like(acc)
    nvel = torch.empty_like(acc)
    _launch(pos, vel, radius, pos, gm, dt, pos_dt, precise, acc, npos, nvel,
            plan=plan)
    return npos, nvel, acc
