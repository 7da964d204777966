"""The ring of a sharded direct-sum substep: its schedule, the executor that
walks it over a list of devices, and the hop kernel's wrapper, each with
its plain PyTorch version beside it.

Counterpart of ``ring_substep`` in ``nbody_tpu/ops/ring_forces.py`` (the
Pallas kernel K3) and of the ``ppermute`` ring in
``nbody_tpu/parallel/sharding.py``. JAX runs one program per device under
``shard_map``; the port is single-controller: one process enqueues the work
of every shard, and a device may stand for several shards (D shards on one
card, as the JAX suite runs D virtual CPU devices).

The ring. Shard d owns two source slots. Before each force evaluation a
*gather* fills d's slot 0 with d's source rows (rows [d·s_loc, (d+1)·s_loc)
of the global padded positions, which may lie in one or two target shards)
and their gm. At hop h, shard d computes on slot h % 2, which holds the
sources of shard (d − h) mod D, while a *send* copies that slot on to shard
d+1's slot (h+1) % 2. Each shard has a compute stream and a copy stream,
and CUDA events play K3's semaphores:

  * a compute waits for the gather or send that filled its slot;
  * a send waits for its slot to be filled, and for the receiving shard's
    compute and send that last read the slot it overwrites (K3's "slot
    freed" backpressure, ``ring_forces.py:117-125``, ``:201-213``);
  * every gather waits for every shard's last work before it, so each
    force evaluation reads pre-step positions (Jacobi).

:func:`ring_schedule` lists these operations and their waits as data.
:class:`Ring` walks the same list on CUDA shards (streams and events) and on
CPU shards (in order, events ignored); a CPU test checks the list itself.

Across processes (a world over a ``torch.distributed`` group, whose ranks
each hold L of the D shards) the ring has no slots: once a force
evaluation every rank ``all_gather``s the source rows of every shard in
shard order (``ops/collective.py``), and each local shard then runs its D
hops in the schedule's order, hop h reading the sources of shard
(d − h) mod D from the gathered rows, on the caller's stream. The hops get
the same inputs in the same order as on the single controller, so they
give the same bits.

Per hop, :func:`ring_substep` launches the hop kernel
(``csrc/ring_forces.cu``), whose last hop also integrates;
:func:`ring_force` calls the direct kernel (``direct_forces.force_acc``),
the hop kernel without its epilogue, or the plain version, and leaves the
integration to the caller. On CPU tensors the wrappers take their plain
versions; on CUDA tensors they launch their kernel or raise.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass

import torch

from .. import forces
from ..types import DTYPE
from . import direct_forces
from .collective import group_of
from .direct_forces import (MAX_CLUSTER, _check, _checked_plan, _device_of,
                            _pos_dt_times_dt, _raise_on, cluster_plan,
                            device_sms)

# Hop-kernel launches made by ``ring_hop`` in this process (plain-version
# calls are not counted), and the plan of each ({Plan: launches}). A run
# resets them and reads them back.
LAUNCHES = 0
PLANS: Counter = Counter()


def _lib():
    from . import _build

    return _build.load("ring_forces")


# --- the hop kernel ---------------------------------------------------------

def ring_hop_plain(tgt_pos, tgt_radius, src_pos, src_gm, acc_run, *,
                   accumulate: bool, precise: bool = False, vel=None,
                   valid=None, dt: float = 0.0, pos_dt: float = 1.0):
    """Plain version of :func:`ring_hop`."""
    hop = forces.direct_sum_acc(tgt_pos, tgt_radius, src_pos[:src_gm.shape[0]],
                                src_gm, precise=precise)
    acc = acc_run + hop if accumulate else hop
    if vel is None:
        acc_run.copy_(acc)
        return None
    acc = acc * valid[:, None]
    nvel = vel + dt * acc
    return tgt_pos + _pos_dt_times_dt(pos_dt, dt) * nvel, nvel, acc


def ring_hop(
    tgt_pos: torch.Tensor,     # (T, 2)
    tgt_radius: torch.Tensor,  # (T,)
    src_pos: torch.Tensor,     # (>= S, 2): the slot's positions
    src_gm: torch.Tensor,      # (S,) G * mass of the visiting real sources
    acc_run: torch.Tensor,     # (T, 2) running sum over the hops
    *,
    accumulate: bool,
    precise: bool = False,
    vel: torch.Tensor | None = None,    # (T, 2), the last hop only
    valid: torch.Tensor | None = None,  # (T,), the last hop only
    dt: float = 0.0,
    pos_dt: float = 1.0,
    t_real: int | None = None,
    plan: tuple | None = None,
):
    """One hop of the ring on one shard (one launch of the K3 kernel): the
    force on T targets of the S = len(src_gm) visiting sources.

    The launch follows ``direct_forces.cluster_plan``, with ``t_real`` the
    real targets among the T (the shard's rows below N; all T by default),
    or ``plan`` (p, n_split) where given; a split of more than the card's
    cluster size is refused and raises.

    Not the last hop (``vel`` is None): ``acc_run`` becomes the hop's force,
    or ``acc_run`` + the hop's force with ``accumulate``, in place; returns
    None. The last hop (``vel`` and ``valid`` given): a = (``acc_run`` +)
    hop, masked by ``valid``, v' = v + dt·a, x' = x + (pos_dt·dt)·v';
    returns new (pos, vel, acc) in fresh buffers. ``dt`` is a Python float,
    so the call makes no host sync."""
    global LAUNCHES
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src_gm.shape[0]
    if src_pos.shape[0] < s:
        raise ValueError(f"src_gm has {s} sources but src_pos only "
                         f"{src_pos.shape[0]} rows")
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src_pos", src_pos, (src_pos.shape[0], 2), device)
    _check("src_gm", src_gm, (s,), device)
    _check("acc_run", acc_run, (t, 2), device)
    last = vel is not None
    if last:
        _check("vel", vel, (t, 2), device)
        _check("valid", valid, (t,), device)
    kw = dict(accumulate=accumulate, precise=precise, vel=vel, valid=valid,
              dt=dt, pos_dt=pos_dt)
    if device.type == "cpu":
        return ring_hop_plain(tgt_pos, tgt_radius, src_pos, src_gm, acc_run,
                              **kw)
    plan = (cluster_plan(t, s, device_sms(device), t_real=t_real,
                         max_split=MAX_CLUSTER)
            if plan is None else _checked_plan(plan))
    out = [torch.empty((t, 2), dtype=DTYPE, device=device)
           for _ in range(3)] if last else [None] * 3

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(device):
        err = _lib().nbody_ring_hop(
            tgt_pos.data_ptr(), tgt_radius.data_ptr(), src_pos.data_ptr(),
            src_gm.data_ptr(), t, s, acc_run.data_ptr(), int(accumulate),
            int(last), ptr(vel), ptr(valid), float(dt), float(pos_dt),
            int(precise), plan.p, plan.n_split, *(ptr(x) for x in out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "ring_forces")
    LAUNCHES += 1
    PLANS[plan] += 1
    if not last:
        return None
    acc, npos, nvel = out
    return npos, nvel, acc


# --- the schedule -----------------------------------------------------------

@dataclass(frozen=True)
class Op:
    """One operation of the ring. ``kind`` "gather" and "send" run on shard
    ``shard``'s copy stream, "compute" on its compute stream. The operation
    waits for the events ``waits``, runs, and records the event ``key``.
    ``reads`` and ``writes`` name the (shard, slot) pairs it touches."""

    kind: str
    shard: int
    hop: int
    waits: tuple
    reads: tuple = ()
    writes: tuple = ()
    last: bool = False  # a compute of the last hop: it carries the epilogue

    @property
    def key(self) -> tuple:
        return (self.kind, self.shard, self.hop)

    @property
    def stream(self) -> tuple:
        return ("compute" if self.kind == "compute" else "copy", self.shard)


def ring_schedule(n_devices: int) -> tuple[Op, ...]:
    """The operations of one pass round a ring of ``n_devices`` shards, in
    the order they are enqueued: D gathers, then per hop h the D sends of
    hop h (none at the last hop) and the D computes of hop h. Events named
    ("ready", k) are recorded on shard k's compute stream by the caller
    before the pass."""
    d = n_devices

    def filler(s, h):  # the operation that fills slot h % 2 of shard s for hop h
        return ("gather", s, 0) if h == 0 else ("send", (s - 1) % d, h - 1)

    ready = tuple(("ready", k) for k in range(d))
    ops = [Op("gather", s, 0, ready, writes=((s, 0),)) for s in range(d)]
    for h in range(d):
        if h < d - 1:
            for s in range(d):
                nxt = (s + 1) % d
                waits = (filler(s, h),)
                if h >= 1:
                    # the slot it overwrites was last read at hop h - 1 by
                    # the neighbour's compute and by the neighbour's send
                    waits += (("compute", nxt, h - 1), ("send", nxt, h - 1))
                ops.append(Op("send", s, h, waits, reads=((s, h % 2),),
                              writes=((nxt, (h + 1) % 2),)))
        for s in range(d):
            ops.append(Op("compute", s, h, (filler(s, h),),
                          reads=((s, h % 2),), last=h == d - 1))
    return tuple(ops)


def source_pieces(shard: int, s_loc: int, t_loc: int, n: int) -> list[tuple]:
    """Where the first ``n`` source rows of ``shard`` lie: (target shard k,
    first row in k, end row in k, first row in the slot) for rows
    [shard·s_loc, shard·s_loc + n) of the global padded order, cut at the
    target shard boundaries of ``t_loc`` rows."""
    pieces = []
    r, end = shard * s_loc, shard * s_loc + n
    while r < end:
        k = r // t_loc
        hi = min(end, (k + 1) * t_loc)
        pieces.append((k, r - k * t_loc, hi - k * t_loc, r - shard * s_loc))
        r = hi
    return pieces


# --- the executor -----------------------------------------------------------

class Ring:
    """The ring of a sharded world over ``devices`` (one entry per shard of
    this process; a device may repeat): two slots per shard, each an
    (s_loc, 2) block of positions followed by (s_loc,) gm in one buffer, so
    one copy moves a slot; a running acceleration per shard for the hop
    kernel; and on CUDA a compute and a copy stream per shard with the
    schedule's events.

    ``n_real[k]`` is the number of real sources of shard k (rows below
    mass_len): computes read only those. ``t_real[j]`` is the number of
    real targets of local shard j (rows below ``n_targets``, all rows by
    default), from which its launches are planned. ``serial = True``
    synchronises the card after every operation, a schedule that cannot
    race, against which the overlapped one must be bit-equal.

    With a ``group`` (``collective.ShardGroup``) the shards are this
    rank's L of D over the group's processes, ``gm_src`` holds every
    shard's gm (the same on every rank), and a pass gathers the sources
    instead of sending slots (the module's docstring); without one the
    ring is the single controller's."""

    def __init__(self, devices, t_loc: int, s_loc: int, mass_len: int,
                 gm_src, n_targets: int | None = None, group=None):
        self.devices = [torch.device(x) for x in devices]
        self.group = group_of(group)
        n_local = len(self.devices)
        d = self.n_devices = self.group.n_shards(n_local)
        self.first = self.group.first(n_local)
        self.s_loc = s_loc
        self.n_real = [min(max(mass_len - k * s_loc, 0), s_loc)
                       for k in range(d)]
        n_targets = d * t_loc if n_targets is None else n_targets
        self.t_real = [min(max(n_targets - k * t_loc, 0), t_loc)
                       for k in range(self.first, self.first + n_local)]
        self.gm_src = gm_src
        self.acc_run = [torch.zeros((t_loc, 2), dtype=DTYPE, device=dev)
                        for dev in self.devices]
        self.cuda = self.devices[0].type == "cuda"
        self.serial = False
        self.streams = {}
        self.events = {}
        if self.group.pg is not None:
            # the rows of [0, mass_len) that each shard holds as targets
            self.prefix_rows = [min(max(mass_len - k * t_loc, 0), t_loc)
                                for k in range(d)]
            self.streamed = False
            return
        self.schedule = ring_schedule(d)
        self.pieces = [source_pieces(k, s_loc, t_loc, self.n_real[k])
                       for k in range(d)]
        self.slots = [[torch.zeros(3 * s_loc, dtype=DTYPE, device=dev)
                       for _ in range(2)] for dev in self.devices]
        self.streamed = self.cuda
        if self.cuda:
            for k, dev in enumerate(self.devices):
                for kind in ("compute", "copy"):
                    self.streams[(kind, k)] = torch.cuda.Stream(dev)

    def slot(self, shard: int, index: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(positions (s_loc, 2), gm (s_loc,)) views of a slot."""
        buf = self.slots[shard][index]
        return buf[:2 * self.s_loc].view(self.s_loc, 2), buf[2 * self.s_loc:]

    def visiting(self, op: Op) -> tuple[torch.Tensor, torch.Tensor]:
        """The real sources in the slot a compute reads: those of shard
        (shard − hop) mod D."""
        n = self.n_real[(op.shard - op.hop) % self.n_devices]
        pos, gm = self.slot(*op.reads[0])
        return pos[:n], gm[:n]

    def _event(self, key) -> torch.cuda.Event:
        if key not in self.events:
            self.events[key] = torch.cuda.Event()
        return self.events[key]

    @contextlib.contextmanager
    def on(self, shard: int, kind: str = "compute"):
        """Run what the block enqueues on shard ``shard``'s ``kind`` stream
        ("compute" or "copy"); on the CPU, and across processes, on the
        caller's stream."""
        if not self.streamed:
            yield
            return
        with torch.cuda.stream(self.streams[(kind, shard)]):  # and its device
            yield

    @contextlib.contextmanager
    def fork(self):
        """Order the shards' streams after the work the caller's current
        streams hold, and the caller's current streams after the shards'
        work at exit: tensors cross between them as if one stream ran it
        all. Nothing to do where there are no streams."""
        if not self.streamed:
            yield
            return
        mine = sorted({dev.index for dev in self.devices})
        for i in mine:
            self._event(("fork", i)).record(torch.cuda.current_stream(i))
        for (kind, k), stream in self.streams.items():
            stream.wait_event(self._event(("fork", self.devices[k].index)))
        try:
            yield
        finally:
            for k in range(len(self.devices)):
                self._event(("join", k)).record(self.streams[("compute", k)])
            for i in mine:
                for k in range(len(self.devices)):
                    torch.cuda.current_stream(i).wait_event(
                        self._event(("join", k)))

    def synchronize(self) -> None:
        """Wait for every card the shards are on (nothing on the CPU)."""
        if self.cuda:
            for i in sorted({dev.index for dev in self.devices}):
                torch.cuda.synchronize(i)

    def _gather(self, op: Op, pos) -> None:
        shard = op.shard
        spos, sgm = self.slot(*op.writes[0])
        for k, lo, hi, off in self.pieces[shard]:
            if self.cuda:  # read on this copy stream, allocated on another
                pos[k].record_stream(self.streams[("copy", shard)])
            spos[off:off + hi - lo].copy_(pos[k][lo:hi], non_blocking=True)
        n = self.n_real[shard]
        sgm[:n].copy_(self.gm_src[shard][:n], non_blocking=True)

    def run(self, pos, compute) -> None:
        """One pass round the ring: gather every shard's sources from the
        per-shard positions ``pos``, then for each compute of the schedule
        call ``compute(j, hop, last, src_pos, src_gm)`` for local shard j
        on its compute stream with the real sources visiting it; ``last``
        marks the compute that carries the epilogue."""
        if self.group.pg is not None:
            self._run_gathered(pos, compute)
            return
        if self.cuda:
            for k in range(self.n_devices):
                self._event(("ready", k)).record(self.streams[("compute", k)])
        for op in self.schedule:
            with self.on(op.shard, op.stream[0]):
                if self.cuda:
                    stream = self.streams[op.stream]
                    for key in op.waits:
                        stream.wait_event(self._event(key))
                if op.kind == "gather":
                    self._gather(op, pos)
                elif op.kind == "send":
                    (src, i), = op.reads
                    (dst, j), = op.writes
                    self.slots[dst][j].copy_(self.slots[src][i],
                                             non_blocking=True)
                else:
                    compute(op.shard, op.hop, op.last, *self.visiting(op))
                if self.cuda:
                    self._event(op.key).record(stream)
                    if self.serial:
                        self.synchronize()

    def _run_gathered(self, pos, compute) -> None:
        """The pass across processes: one gather of the rows [0, mass_len)
        of every shard, then the computes in the schedule's order (hop by
        hop, the shards in order), on the caller's stream."""
        dev0 = self.devices[0]
        mine = self.prefix_rows[self.first:self.first + len(self.devices)]
        prefix = torch.cat(self.group.gather(
            [p[:r] for p, r in zip(pos, mine)], dev0, self.prefix_rows))
        d, s = self.n_devices, self.s_loc
        for h in range(d):
            for j, dev in enumerate(self.devices):
                k = (self.first + j - h) % d
                n = self.n_real[k]
                compute(j, h, h == d - 1, prefix[k * s:k * s + n].to(dev),
                        self.gm_src[k][:n].to(dev))
                if self.serial:
                    self.synchronize()


def ring_substep(ring: Ring, dt: float, pos, vel, radius, valid, *,
                 precise: bool = False, pos_dt: float = 1.0):
    """One fused substep of every shard through the hop kernel: D launches
    per shard, the last with the integration epilogue (the ``ring_substep``
    counterpart, for all D shards in one call). ``pos``, ``vel``,
    ``radius`` and ``valid`` are per-shard lists. ``pos_dt=0.5`` makes the
    epilogue the kick and half-drift of a DKD stage. Returns new per-shard
    lists (pos, vel, acc); the inputs are not modified."""
    out = [None] * len(ring.devices)

    def compute(k, h, last, src_pos, src_gm):
        kw = dict(vel=vel[k], valid=valid[k], dt=dt, pos_dt=pos_dt) if last else {}
        res = ring_hop(pos[k], radius[k], src_pos, src_gm, ring.acc_run[k],
                       accumulate=h > 0, precise=precise,
                       t_real=ring.t_real[k], **kw)
        if last:
            out[k] = res
    ring.run(pos, compute)
    return tuple(list(x) for x in zip(*out))


def ring_force(ring: Ring, pos, radius, valid, *, precise: bool = False,
               backend: str = "cuda") -> list:
    """Per-shard accelerations over the whole ring, masked by ``valid``,
    with no integration. Per hop, by ``backend``: "cuda" the direct kernel
    (``direct_forces.force_acc``, planned for the shard's real targets),
    "cuda_ring" the hop kernel without its epilogue (``ring_hop`` summing
    into the shard's running acceleration), "torch" the plain version.
    Hop sums are added in hop order (JAX's ``acc + local``). On CPU
    shards each takes its plain version."""
    if backend not in ("torch", "cuda", "cuda_ring"):
        raise ValueError(f"backend must be 'torch', 'cuda' or 'cuda_ring', "
                         f"got {backend!r}")
    acc = [None] * len(ring.devices)

    def compute(k, h, last, src_pos, src_gm):
        if backend == "cuda_ring":
            ring_hop(pos[k], radius[k], src_pos, src_gm, ring.acc_run[k],
                     accumulate=h > 0, precise=precise,
                     t_real=ring.t_real[k])
            if last:
                acc[k] = ring.acc_run[k] * valid[k][:, None]
            return
        if backend == "torch":
            a = direct_forces.force_acc_plain(pos[k], radius[k], src_pos,
                                              src_gm, precise=precise)
        else:
            a = direct_forces.force_acc(pos[k], radius[k], src_pos, src_gm,
                                        precise=precise,
                                        t_real=ring.t_real[k])
        a = a if h == 0 else acc[k] + a
        acc[k] = a * valid[k][:, None] if last else a
    ring.run(pos, compute)
    return acc


def ring_substep_plain(dt: float, pos, vel, radius, valid, src_pos, src_gm,
                       *, precise: bool = False, pos_dt: float = 1.0):
    """Plain version of :func:`ring_substep`, with no slots and no schedule:
    shard d's acceleration sums, hop by hop, the force of the sources
    ``src_pos[k]``, ``src_gm[k]`` of shard k = (d − h) mod D, then
    integrates as the last hop does. Per-shard lists in, per-shard lists
    (pos, vel, acc) out."""
    d = len(pos)
    out = []
    for s in range(d):
        acc = None
        for h in range(d):
            k = (s - h) % d
            a = forces.direct_sum_acc(pos[s], radius[s], src_pos[k],
                                      src_gm[k], precise=precise)
            acc = a if acc is None else acc + a
        acc = acc * valid[s][:, None]
        nvel = vel[s] + dt * acc
        out.append((pos[s] + _pos_dt_times_dt(pos_dt, dt) * nvel, nvel, acc))
    return tuple(list(x) for x in zip(*out))
