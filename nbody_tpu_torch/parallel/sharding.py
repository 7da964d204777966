"""Particle-space sharding over a list of devices: the ring of source
tiles and the collective mesh solvers. Counterpart of
``nbody_tpu/parallel/sharding.py``.

  * Particles are padded and split along N into D shards of ``t_loc``
    target rows; shard d also owns ``s_loc`` rows of the massive prefix
    (its sources), so the D source shards together cover exactly the
    ``mass_len`` force-exerting particles. The layout (:func:`shard_layout`,
    the padding rows, ``gm_src``) is ``nbody_tpu``'s, integer for integer
    and bit for bit, so shard d carries the same sources in both packages.
  * One process drives every shard (single-controller, as one JAX program
    drives every device of a mesh under ``shard_map``). A mesh is a list of
    ``torch.device``s, one per shard, and may repeat a device: D shards on
    one card, or on the CPU, as the JAX suite runs D virtual CPU devices.
  * Or the shards are spread over the processes of a ``torch.distributed``
    group (``parallel/multihost.py``): the world is built with
    :meth:`ShardedWorld.from_arrays` and the group, its mesh is this rank's
    L shards, and rank r holds shards r·L … r·L + L − 1 of D = P·L. Every
    place where the single controller gathers the shards' pieces onto the
    first shard's device then gathers them from every rank
    (``ops/collective.py``), and every rank runs the same reduction, so
    the ranks hold the same bits as the single controller.
  * On the direct-sum backends each force evaluation is one pass round the
    ring of ``ops/ring_forces.py``: the visiting source slot moves one
    shard per hop by a device-to-device copy on a side stream while the
    shard computes on the other slot; CUDA events play the semaphores.
  * On the mesh backends each force evaluation is a collective
    (``ops/pm_forces.pm_acc_collective``,
    ``ops/p3m_forces.p3m_acc_collective_from_bins``): each shard's
    sources are its rows of the massive prefix, weighted by the shard's
    per-target gm row (``nbody_tpu``'s layout for "pm" and "p3m"); the
    grids and the exact-core partials are summed in shard order, so two
    runs give the same bits. The whole n-substep loop of ``update`` keeps
    "p3m"'s bins frozen for ``p3m_rebin_interval`` substeps and chooses
    the exact-core rows once a call, as ``nbody_tpu``'s grid device loop.

Backends (the port's names for JAX's): "torch" ("jnp") plain per-hop force
then integrate; "cuda" ("pallas") the direct kernel per hop; "cuda_ring"
("pallas_ring") the ring hop kernel K3, whose last hop integrates; "pm" and
"p3m" the collective mesh solvers (on CUDA shards K4, ``p3m_pp.pp_cells``,
once a shard an evaluation, and K1's ``force_acc`` for the exact-core
partials); "auto" resolves by ``nbody_tpu``'s per-chip rule
(:func:`resolve_force_backend`).

A user field ``extra_force(pos, vel)`` is pointwise per shard: it sees
the shard's rows, its term is masked by ``valid`` and added to the
force, and the integration runs in PyTorch on each shard. So does the
adaptive loop, whose dt is a tensor on the device. On "cuda_ring" such a
substep takes its force from the hop kernel without its epilogue.

Under ``SimConfig.merge_collisions`` every substep is followed by one merge
pass (``ops/collisions.merge_pass``): the ``src_len`` rows of the massive
prefix are gathered from the shards, in global row order, onto the first
shard's device, merged there once, and the changed rows and gm copied back
to their shards: the single-controller form of the pass that nbody_tpu
runs on the global sharded arrays. The forces read the shards' gm tensors,
which the merge updates in place. "p3m" does not merge (frozen cell
blocks), as in nbody_tpu.
"""

from __future__ import annotations

import contextlib
import operator
from typing import Literal

import torch
from torch.profiler import record_function

from .. import diagnostics, forces, integrators, world
from ..interop import FIELDS
from ..ops.collective import LOCAL, ShardGroup
from ..ops.collisions import merge_pass
from ..ops.p3m_forces import (p3m_acc_collective_from_bins,
                              p3m_bins_collective,
                              p3m_exact_core_bins_collective)
from ..ops.pm_forces import pm_acc_collective
from ..ops.ring_forces import Ring, ring_force, ring_substep, source_pieces
from ..trajectory import stack_frames
from ..types import DEFAULT_SIM_CONFIG, DTYPE, Particles, SimConfig, round_up
from ..world import _scalar, partition_massive_first

# Source shards align to 128 rows, as in nbody_tpu
# (nbody_tpu/ops/pallas_forces.py:66). There it is the TPU's lane width; here
# it only fixes the layout, which must equal nbody_tpu's so that shard d
# carries the same sources in both packages. No kernel of the port needs it.
SOURCE_ALIGN = 128

RING_BACKENDS = ("torch", "cuda", "cuda_ring")
MESH_BACKENDS = ("pm", "p3m")
FORCE_BACKENDS = RING_BACKENDS + MESH_BACKENDS


class Shards(tuple):
    """One tensor a shard, with elementwise ``+`` and ``*`` (a scalar, or
    one value a shard), so that ``integrators.advance`` runs its stages over
    the shards with the same arithmetic as over one tensor."""

    def _map(self, other, op):
        if isinstance(other, Shards):
            return Shards(op(a, b) for a, b in zip(self, other))
        return Shards(op(a, other) for a in self)

    def __add__(self, other):
        return self._map(other, operator.add)

    def __mul__(self, other):
        return self._map(other, operator.mul)

    def __rmul__(self, other):
        return self._map(other, lambda a, b: b * a)


def shard_layout(n: int, mass_len: int, config: SimConfig, d: int):
    """Padded layout for a D-way sharded world: returns
    (s_loc, t_loc, src_len, n_pad), ``nbody_tpu``'s integer for integer."""
    s_loc = round_up(max(mass_len, 1), SOURCE_ALIGN * d) // d
    if s_loc > config.tile_sources:
        s_loc = round_up(s_loc, config.tile_sources)
    src_len = s_loc * d
    t_loc = round_up(max(n, src_len), 8 * d) // d
    if t_loc > config.tile_targets:
        t_loc = round_up(t_loc, config.tile_targets)
    return s_loc, t_loc, src_len, t_loc * d


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The devices of a 1-D mesh, one per shard: by default every visible
    CUDA device. ``devices`` may repeat a device, e.g.
    ``[torch.device("cuda:0")] * 4`` runs four shards on one card and
    ``["cpu"] * 4`` four on the CPU. Without a CUDA device and without
    ``devices`` it raises: it does not fall back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass devices=[...] to shard over the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(x) for x in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices must be in [1, {len(devices)}], "
                             f"got {n_devices}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    kinds = {x.type for x in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a mesh is all CPU or all CUDA devices, got {devices}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA devices requested but torch.cuda.is_available() is False")
        devices = [x if x.index is not None else
                   torch.device("cuda", torch.cuda.current_device())
                   for x in devices]
    return devices


def padded_state(particles: Particles, mass_len: int, n_pad: int, g: float):
    """Stable massive-first partition padded to ``n_pad`` rows, with the gm
    and valid rows, on the CPU: the counterpart of
    ``nbody_tpu.world._create_padded_state``. Padding rows have mass 0,
    radius 1 and zero pos, vel and acc; gm = g·mass below ``mass_len`` and 0
    above; valid is 1 for the N real rows. Returns (Particles, gm, valid)."""
    mass = particles.mass.to("cpu", DTYPE)
    n = mass.shape[0]
    order, _ = partition_massive_first(mass)

    def pad(x, fill):
        x = torch.as_tensor(x).to("cpu", DTYPE)
        out = torch.full((n_pad,) + tuple(x.shape[1:]), fill, dtype=DTYPE)
        out[:n] = x[order]
        return out

    state = Particles(pos=pad(particles.pos, 0.0), vel=pad(particles.vel, 0.0),
                      acc=pad(particles.acc, 0.0), mass=pad(mass, 0.0),
                      radius=pad(particles.radius, 1.0))
    idx = torch.arange(n_pad)
    gm = torch.where(idx < mass_len, g * state.mass, 0.0)
    valid = (idx < n).to(DTYPE)
    return state, gm, valid


def _prefix_slice(prefix: list, k: int, s_loc: int, t_loc: int, device):
    """Rows [k·s_loc, (k+1)·s_loc) of the source prefix, whose rows lie in
    the pieces ``prefix`` (target shard j's first rows), on ``device``: a
    view of one piece where the rows lie in one, else the pieces' rows
    joined."""
    parts = [prefix[j][lo:hi].to(device)
             for j, lo, hi, _ in source_pieces(k, s_loc, t_loc, s_loc)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def mesh_chips(devices, group=None) -> int:
    """The D of "auto"'s per-chip rule: the distinct cards of a CUDA mesh
    (four shards on one card do all the direct work on that card), and
    every shard of a CPU mesh, which stands for nbody_tpu's virtual CPU
    mesh of D devices. Over a process group (``collective.ShardGroup``)
    ``devices`` is this rank's, and the count is over every rank: the
    group's size times this rank's distinct cards, or every shard on the
    CPU."""
    size = 1 if group is None else group.size
    if devices[0].type == "cpu":
        return size * len(devices)
    return size * len(dict.fromkeys(devices))


def resolve_force_backend(force_backend, devices, total_len: int,
                          mass_len: int, merging: bool = False,
                          group=None) -> str:
    """The backend a sharded world runs: None is the shards' direct backend
    ("cuda" on CUDA shards, "torch" on CPU ones, where nbody_tpu answers
    "pallas" or "jnp"); "auto" is nbody_tpu's per-chip rule
    (``nbody_tpu/parallel/sharding.py:366-391``): the direct sum's
    total_len · mass_len pairs split evenly over the D chips while the
    mesh cost repeats on each, so the direct backend at or below
    ``world.AUTO_P3M_MIN_PAIRS`` pairs a chip and "p3m" above ("pm" under
    merging). D is ``mesh_chips``: shards that share a card share its
    time (over ``group``'s ranks, :func:`mesh_chips`). "p3m" with merging
    raises, as in nbody_tpu."""
    direct = "cuda" if devices[0].type == "cuda" else "torch"
    if force_backend is None:
        return direct
    if force_backend == "auto":
        per_chip = (total_len * mass_len) // mesh_chips(devices, group)
        far = "pm" if merging else "p3m"
        force_backend = direct if per_chip <= world.AUTO_P3M_MIN_PAIRS else far
    elif force_backend not in FORCE_BACKENDS:
        raise ValueError(
            f"unknown force_backend {force_backend!r}; expected one of "
            f"{FORCE_BACKENDS} or 'auto'")
    if merging and force_backend == "p3m":
        raise ValueError(
            "merge_collisions is not supported with force_backend='p3m' "
            "(frozen cell blocks); use 'torch', 'cuda', 'cuda_ring' or 'pm'")
    return force_backend


def shard_group(pg, devices) -> ShardGroup:
    """The ``collective.ShardGroup`` of a world over the process group
    ``pg`` with this rank's ``devices``. NCCL carries CUDA shards and Gloo
    (or MPI) CPU ones; any other pairing raises. Every rank must hold the
    same number of shards, and raises if one does not."""
    import torch.distributed as dist

    backend = str(dist.get_backend(pg)).lower()
    kind = devices[0].type
    if (kind == "cuda") != (backend == "nccl"):
        raise ValueError(
            f"a world of {kind} shards needs "
            f"{'nccl' if kind == 'cuda' else 'a CPU backend (gloo)'} "
            f"collectives, the process group has {backend!r}")
    group = ShardGroup(pg, len(devices))
    counts = group._all_gather(torch.tensor([len(devices)],
                                            device=devices[0]))
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"every rank must hold the same number of shards, "
                         f"the ranks hold {counts}")
    return group


class ShardedWorld:
    """World sharded over a 1-D mesh of devices. Mirrors
    :class:`nbody_tpu_torch.World`: create, ``update(dt, n)``,
    ``particles``.

    Layout: ``n_pad`` = D·``t_loc`` padded rows, shard d holding rows
    [d·t_loc, (d+1)·t_loc). On the ring backends ``src_len`` = D·``s_loc``
    source rows, shard d owning rows [d·s_loc, (d+1)·s_loc) of the massive
    prefix and their gm (``gm_src``, zero past ``mass_len``); on "pm" and
    "p3m" each shard keeps the gm of its own rows (a per-target row, zero
    past ``mass_len``), as in nbody_tpu. Per-shard state is in the lists
    ``pos``, ``vel``, ``acc``, ``mass``, ``radius`` and ``valid``.

    Over a process group (:meth:`from_arrays` with ``group``), ``mesh``
    and the lists hold this rank's L shards, global shards ``first`` …
    ``first`` + L − 1 of ``n_devices`` = D; ``particles`` and ``state``
    raise where the group has more than one rank
    (``multihost.gather_particles`` gathers the whole state)."""

    def __init__(
        self,
        particles: Particles,
        mesh: list | None = None,
        *,
        config: SimConfig = DEFAULT_SIM_CONFIG,
        force_backend: Literal["torch", "cuda", "cuda_ring", "pm", "p3m",
                               "auto"] | None = None,
    ):
        devices = make_mesh(devices=mesh) if mesh is not None else make_mesh()
        n = particles.pos.shape[0]
        mass_len = int(torch.count_nonzero(particles.mass > 0))
        backend = resolve_force_backend(force_backend, devices, n, mass_len,
                                        config.merge_collisions)
        n_pad = shard_layout(n, mass_len, config, len(devices))[3]
        state, gm, valid = padded_state(particles, mass_len, n_pad, config.g)
        t_loc = n_pad // len(devices)

        def split(x):
            return [x[k * t_loc:(k + 1) * t_loc].to(dev).contiguous()
                    for k, dev in enumerate(devices)]

        self._setup(devices, config, backend, n, mass_len,
                    {f: split(getattr(state, f)) for f in FIELDS},
                    split(gm), split(valid))

    @classmethod
    def from_arrays(cls, pos, vel, acc, mass, radius, *, total_len: int,
                    mass_len: int, mesh: list,
                    config: SimConfig = DEFAULT_SIM_CONFIG,
                    force_backend=None, group=None) -> "ShardedWorld":
        """Rebuild a ShardedWorld around PADDED state (the counterpart of
        ``nbody_tpu``'s ``from_arrays``): each field a tensor of the
        ``n_pad`` rows of :func:`shard_layout` for (total_len, mass_len,
        config, mesh size), or the list of its D shards, on any device
        (e.g. :attr:`state`, or the lists ``pos``, ``vel``, ...). Each
        shard's rows are copied straight to its device; the gm and valid
        rows are made again there: gm = g·mass below ``mass_len``, valid =
        1 below ``total_len``.

        With ``group`` (a ``torch.distributed`` process group, every rank
        calling), ``mesh`` is this rank's L devices and each field holds
        this rank's rows: the L·t_loc rows from global row r·L·t_loc on
        rank r, for the layout of D = L × the group's size shards."""
        devices = make_mesh(devices=mesh)
        sg = None if group is None else shard_group(group, devices)
        d = len(devices) * (1 if sg is None else sg.size)
        t_loc = shard_layout(total_len, mass_len, config, d)[1]
        rows = len(devices) * t_loc

        def shards(name, x):
            if isinstance(x, (list, tuple)):
                pieces = list(x)
                shape = (sum(p.shape[0] for p in pieces),
                         *pieces[0].shape[1:]) if pieces else (0,)
                fits = len(pieces) == len(devices) and all(
                    p.shape[0] == t_loc for p in pieces)
            else:
                x = torch.as_tensor(x)
                shape = tuple(x.shape)
                pieces = [x[k * t_loc:(k + 1) * t_loc]
                          for k in range(len(devices))]
                fits = shape[0] == rows
            want = (rows, 2) if name in ("pos", "vel", "acc") else (rows,)
            if not fits or tuple(shape) != want:
                raise ValueError(
                    f"restored {name} shape {tuple(shape)} does not match "
                    f"the layout for n={total_len}, mass_len={mass_len}, "
                    f"D={d}: {want} on this process; restore with the same "
                    "config and mesh size as the save")
            return [p.to(dev, DTYPE, copy=True).contiguous()
                    for p, dev in zip(pieces, devices)]

        given = dict(zip(FIELDS, (pos, vel, acc, mass, radius)))
        return cls._from_shards({f: shards(f, x) for f, x in given.items()},
                                total_len=total_len, mass_len=mass_len,
                                devices=devices, config=config,
                                force_backend=force_backend, group=sg)

    @classmethod
    def _from_shards(cls, shards: dict, *, total_len: int, mass_len: int,
                     devices: list, config: SimConfig, force_backend,
                     group: ShardGroup | None) -> "ShardedWorld":
        """A world around this process's padded shards, which it takes as
        its own: ``shards`` maps each of :data:`FIELDS` to one tensor a
        local shard, of ``t_loc`` rows, on that shard's device. The gm and
        valid rows are made on each shard's device from the global row
        index; no state row leaves its device."""
        self = cls.__new__(cls)
        backend = resolve_force_backend(force_backend, devices, total_len,
                                        mass_len, config.merge_collisions,
                                        group=group)
        first = 0 if group is None else group.first(len(devices))
        t_loc = shards["pos"][0].shape[0]
        gm, valid = [], []
        for j, (m, dev) in enumerate(zip(shards["mass"], devices)):
            idx = (first + j) * t_loc + torch.arange(t_loc, device=dev)
            gm.append(torch.where(idx < mass_len, config.g * m, 0.0))
            valid.append((idx < total_len).to(DTYPE))
        self._setup(devices, config, backend, total_len, mass_len, shards,
                    gm, valid, group=group)
        return self

    def _setup(self, devices, config, backend, n, mass_len, shards, gm,
               valid, group=None) -> None:
        """Take this process's padded shards (``shards``: field -> one
        tensor a local shard on its device; ``gm`` and ``valid`` alike) and
        build the backend's source layout (the ring, or the mesh solvers'
        rows). ``group``: a ``collective.ShardGroup``, or None for the
        single controller (whose shards are all the shards)."""
        self.mesh = devices
        self.group = LOCAL if group is None else group
        d = self.n_devices = self.group.n_shards(len(devices))
        first = self.first = self.group.first(len(devices))
        self.config = config
        self.force_backend = backend
        s_loc, t_loc, src_len, n_pad = shard_layout(n, mass_len, config, d)
        self.total_len, self.mass_len = n, mass_len
        self.s_loc, self.t_loc, self.src_len, self.n_pad = (
            s_loc, t_loc, src_len, n_pad)
        self.pos, self.vel, self.acc = (list(shards[f])
                                        for f in ("pos", "vel", "acc"))
        self.mass, self.radius = list(shards["mass"]), list(shards["radius"])
        self.valid = valid
        # the rows of [0, src_len) that each shard holds as targets: the
        # merge pass's prefix
        self._prefix_rows = [min(max(src_len - k * t_loc, 0), t_loc)
                             for k in range(d)]
        if backend in MESH_BACKENDS:
            # the mesh solvers' sources: the first max(mass_len, 1) rows
            # (World's _mesh_sources), each shard's share of them
            n_src = max(mass_len, 1)
            src_rows = [min(max(n_src - k * t_loc, 0), t_loc)
                        for k in range(d)]
            self._src_rows = src_rows[first:first + len(devices)]
            if group is not None:
                group.src_rows = src_rows
            self._gm_src = gm
            self._softening = [world._scalar(config.pm_softening, dev)
                               for dev in devices]
            self.ring = None
        else:
            # source shard k's gm: rows [k·s_loc, (k+1)·s_loc) of the
            # prefix, on device k; over a group every shard's, the same on
            # every rank, on the first local device: gathered once here,
            # changed only by the merge pass, which every rank runs on the
            # same gathered rows
            mine = self._prefix_rows[first:first + len(devices)]
            prefix = [g[:r] for g, r in zip(gm, mine)]
            homes = devices
            if group is not None:
                prefix = group.gather(prefix, devices[0], self._prefix_rows)
                homes = [devices[0]] * d
            self._gm_src = [_prefix_slice(prefix, k, s_loc, t_loc, dev)
                            for k, dev in enumerate(homes)]
            self.ring = Ring(devices, t_loc, s_loc, mass_len, self._gm_src,
                             n_targets=n, group=group)
        self._host_cache: Particles | None = None

    @property
    def gm_src(self) -> torch.Tensor:
        """The whole gm row on the CPU: (src_len,) on the ring backends,
        the per-target (n_pad,) row on "pm" and "p3m", as in nbody_tpu
        (gathered from every rank over a process group)."""
        gms = (self._gm_src if self.ring is not None
               else self.group.gather(self._gm_src, self.mesh[0]))
        return torch.cat([g.cpu() for g in gms])

    def _fork(self):
        return self.ring.fork() if self.ring is not None \
            else contextlib.nullcontext()

    def _on(self, k: int):
        return self.ring.on(k) if self.ring is not None \
            else contextlib.nullcontext()

    def update(self, dt: float, n: int = 1, extra_force=None) -> "ShardedWorld":
        """n substeps of size dt. ``extra_force(pos, vel) -> acc`` composes
        a user acceleration field with self-gravity per shard: a pointwise
        per-particle function, which sees one shard's rows. Under merging,
        each substep is followed by a merge pass. The loop never syncs with
        the host: ``dt`` stays a Python float, and only ``particles`` and
        ``block_until_ready`` wait."""
        if n <= 0:
            return self
        if self.ring is None:
            self._mesh_update(float(dt), n, extra_force)
            self._host_cache = None
            return self
        dts = [float(dt)] * len(self.mesh)
        if not self.config.merge_collisions:
            with self.ring.fork():
                for _ in range(n):
                    self._substep(dts, extra_force)
        else:
            for _ in range(n):
                with self.ring.fork():
                    self._substep(dts, extra_force)
                self._merge()
        self._host_cache = None
        return self

    def update_adaptive(self, t_span: float, *, eta: float = 0.1,
                        dt_min: float = 1e-5, dt_max: float = 1.0,
                        extra_force=None) -> int:
        """Integrate ``t_span`` physical time units with per-substep global
        adaptive dt, as :func:`nbody_tpu_torch.world.update_state_adaptive`
        does for a World; returns the number of substeps taken. The
        criterion's min runs over every shard, in shard order, on the first
        shard's device, so every shard steps with the same dt. Padding rows
        hold acc exactly 0 (masked by ``valid``), a timescale of +inf. A
        substep past the end keeps the old state (under merging its mass,
        radius and gm too: no merge happens there); the priming dt = 0
        substep merges, as nbody_tpu's does. Over a process group the
        criterion's min runs over every rank's shards, gathered in shard
        order, so every rank takes the same dt and the same count."""
        dev0 = self.mesh[0]
        merging = self.config.merge_collisions
        knobs = {key: _scalar(v, dev0) for key, v in (
            ("dt_min", dt_min), ("dt_max", dt_max), ("t_span", t_span))}
        eta = _scalar(eta, dev0)
        with self._fork():  # prime acc: dt = 0, nothing moves
            self._substep([_scalar(0.0, dev) for dev in self.mesh],
                          extra_force)
        if merging:
            self._merge()
        t = _scalar(0.0, dev0)
        k = torch.zeros((), dtype=torch.int32, device=dev0)
        while True:
            for _ in range(world.ADAPTIVE_BATCH):
                live = t < knobs["t_span"]
                crit = eta * torch.stack(self.group.gather(
                    [diagnostics.timescale(a, r)
                     for a, r in zip(self.acc, self.radius)], dev0)).amin()
                dt = torch.where(live, diagnostics.clip_dt(
                    crit, t=t, **knobs), 0.0)
                old = (self.pos, self.vel, self.acc, self.radius, self.mass)
                lives = [live.to(dev) for dev in self.mesh]
                with self._fork():
                    self._substep([dt.to(dev) for dev in self.mesh],
                                  extra_force)
                    # a substep past the end keeps the old state
                    for j in range(0 if merging else len(self.mesh)):
                        with self._on(j):
                            for new, prev in zip(
                                    (self.pos, self.vel, self.acc), old):
                                new[j] = torch.where(lives[j], new[j], prev[j])
                if merging:  # masks after the merge, the state's every field
                    self._merge(live, old)
                t = t + dt
                k = k + live.to(torch.int32)
            if not world._host(t < knobs["t_span"]):
                break
        self._host_cache = None
        return world._host(k)

    def _merged(self) -> tuple:
        """Per-shard (pos, vel, radius, mass, gm_src) lists after one merge
        pass over the massive prefix, run once on the first shard's device
        (over a process group: on every rank, from the prefix gathered from
        every rank, each keeping its own rows); the world's own lists are
        not modified. On the ring backends the gm list holds every shard's
        gm."""
        dev0 = self.mesh[0]
        # rows [k·t_loc, k·t_loc + rows) of the src_len prefix rows lie in
        # shard k
        mine = self._prefix_rows[self.first:self.first + len(self.mesh)]

        def gather(xs):
            return torch.cat(self.group.gather(
                [x[:r] for x, r in zip(xs, mine)], dev0, self._prefix_rows))

        def scatter(xs, merged):
            new = list(xs)
            for j, rows in enumerate(mine):
                if rows:
                    lo = (self.first + j) * self.t_loc
                    new[j] = torch.cat([merged[lo:lo + rows].to(self.mesh[j]),
                                        xs[j][rows:]])
            return new

        ring = self.ring is not None
        gm = (torch.cat([g.to(dev0) for g in self._gm_src]) if ring
              else gather(self._gm_src))
        out = merge_pass(gather(self.pos), gather(self.vel),
                         gather(self.radius), gather(self.mass), gm,
                         factor=self.config.merge_factor, g=self.config.g)
        lists = [scatter(xs, merged) for xs, merged in zip(
            (self.pos, self.vel, self.radius, self.mass), out[:4])]
        if ring:
            s = self.s_loc
            gms = [out[4][k * s:(k + 1) * s].to(g.device)
                   for k, g in enumerate(self._gm_src)]
        else:
            gms = scatter(self._gm_src, out[4])
        return (*lists, gms)

    def _merge(self, live=None, old=None) -> None:
        """Apply one merge pass; with ``live`` (a 0-dim bool on the first
        shard's device) and ``old`` (the pre-substep pos, vel, acc, radius,
        mass lists), where ``live`` is False every shard keeps ``old`` and
        its gm. The shards' gm tensors are updated in place, where the
        forces read them."""
        pos, vel, radius, mass, gms = self._merged()
        acc = self.acc
        if live is not None:
            def keep(new, prev):
                return [torch.where(live.to(a.device), a, b)
                        for a, b in zip(new, prev)]
            pos, vel, acc, radius, mass = (
                keep(a, b) for a, b in zip((pos, vel, acc, radius, mass), old))
            gms = keep(gms, self._gm_src)
        self.pos, self.vel, self.acc = pos, vel, acc
        self.radius, self.mass = radius, mass
        for g, new in zip(self._gm_src, gms):
            g.copy_(new)

    def record(self, dt: float, frames: int, steps_per_frame: int = 1,
               extra_force=None):
        """Trajectory capture: ``frames`` × ``steps_per_frame`` substeps (as
        :meth:`update`), the positions of the N real rows gathered onto the
        first shard's device after each frame and stacked there, then
        copied to the host once. Advances the world's state. Returns a host
        numpy array (frames, total_len, 2)."""
        return self._capture(dt, frames, steps_per_frame, extra_force,
                             lambda st, gm: st.pos[:self.total_len])

    def record_observables(self, dt: float, frames: int,
                           steps_per_frame: int = 1, extra_force=None,
                           energy: str | None = "exact", capture=None,
                           **capture_kw) -> dict:
        """Observable streaming, the sharded form of
        :func:`nbody_tpu_torch.trajectory.record_observables`: after each
        frame ``capture(state, gm)`` (default
        ``diagnostics.observables_capture``) runs on the padded state
        gathered onto the first shard's device (:attr:`state`; padding rows
        have mass 0) and the whole ``gm_src`` row; the series are stacked on
        the device and copied to the host once. Advances the world's state;
        returns host numpy series keyed by observable, plus ``"time"``."""
        diagnostics.check_observables_args(capture, energy, capture_kw)
        if capture is None:
            capture = diagnostics.observables_capture(
                self.mass_len, energy=energy, **capture_kw)
        series = self._capture(dt, frames, steps_per_frame, extra_force,
                               capture, host=False)
        return diagnostics.observables_series_out(series, frames,
                                                  steps_per_frame, dt)

    def _capture(self, dt, frames, steps_per_frame, extra_force, capture,
                 host=True):
        dev0 = self.mesh[0]
        out = []
        for _ in range(frames):
            self.update(dt, steps_per_frame, extra_force=extra_force)
            out.append(capture(self.state, torch.cat(
                [g.to(dev0) for g in self._gm_src])))
        stacked = stack_frames(out)
        return stacked.cpu().numpy() if host else stacked

    def _whole(self, what: str) -> None:
        if self.group.size > 1:
            raise RuntimeError(
                f"ShardedWorld.{what} holds only this rank's shards of a "
                f"world over {self.group.size} processes; call "
                "parallel.multihost.gather_particles(world) on every rank "
                "for the whole state")

    @property
    def state(self) -> Particles:
        """The padded state (``n_pad`` rows, shard order) gathered onto the
        first shard's device: the same view as ``World.state``, for
        diagnostics and checks. Raises over a group of several ranks."""
        self._whole("state")
        dev0 = self.mesh[0]

        def cat(xs):
            return torch.cat([x.to(dev0) for x in xs])

        return Particles(pos=cat(self.pos), vel=cat(self.vel),
                         acc=cat(self.acc), mass=cat(self.mass),
                         radius=cat(self.radius))

    # -- the mesh backends ---------------------------------------------

    def _sources(self, ps) -> tuple[list, list]:
        """Each shard's sources for the mesh solvers: its rows of the first
        max(mass_len, 1) rows, at positions ``ps``, and their gm."""
        return ([p[:r] for p, r in zip(ps, self._src_rows)],
                [g[:r] for g, r in zip(self._gm_src, self._src_rows)])

    def _masked(self, acc: list) -> list:
        return [a * m[:, None] for a, m in zip(acc, self.valid)]

    def _pm_force(self):
        """``force(ps) -> list``: the collective PM, masked by ``valid``."""
        cfg = self.config

        def force(ps):
            src, gm = self._sources(ps)
            return self._masked(pm_acc_collective(
                list(ps), src, gm, self._softening, grid=cfg.pm_grid,
                tgt_mask=self.valid, group=self.group))
        return force

    def _exact_core_bins(self):
        """The exact-core selection, made once an update call (radius is
        constant without merging, and "p3m" does not merge)."""
        if not self.config.p3m_exact_targets:
            return None
        return p3m_exact_core_bins_collective(
            self.radius, exact_targets=self.config.p3m_exact_targets,
            tgt_mask=self.valid, group=self.group)

    def _p3m_bins(self, ps, big) -> dict:
        cfg = self.config
        with record_function("p3m.bins"):
            src, gm = self._sources(ps)
            return p3m_bins_collective(
                list(ps), self.radius, src, gm, grid=cfg.pm_grid,
                rc_cells=cfg.p3m_rc_cells,
                cell_capacity=cfg.p3m_cell_capacity,
                exact_targets=cfg.p3m_exact_targets, tgt_mask=self.valid,
                big_bins=big, group=self.group)

    def _p3m_force(self, bins):
        """``force(ps) -> list``: the collective P³M through the frozen
        ``bins``, masked by ``valid``."""
        cfg = self.config

        def force(ps):
            src, gm = self._sources(ps)
            return self._masked(p3m_acc_collective_from_bins(
                bins, list(ps), self.radius, src, gm, self._softening,
                grid=cfg.pm_grid, rc_cells=cfg.p3m_rc_cells,
                cell_capacity=cfg.p3m_cell_capacity, precise=cfg.precise,
                group=self.group))
        return force

    def _mesh_update(self, dt: float, n: int, extra_force) -> None:
        """n substeps on "pm" or "p3m": nbody_tpu's grid device loop. "p3m"
        builds its bins at every substep index (from this call's start)
        that is a multiple of ``p3m_rebin_interval`` and chooses the
        exact-core rows once; under merging ("pm") each substep is followed
        by a merge pass."""
        if self.force_backend == "pm":
            force = self._pm_force()
            for _ in range(n):
                self._mesh_substep(dt, force, extra_force)
                if self.config.merge_collisions:
                    self._merge()
            return
        big = self._exact_core_bins()
        for i in range(n):
            if i % self.config.p3m_rebin_interval == 0:
                force = self._p3m_force(self._p3m_bins(self.pos, big))
            self._mesh_substep(dt, force, extra_force)

    def _mesh_substep(self, dt, force, extra_force) -> None:
        """One substep of the integrator's stage loop over the shards
        (``integrators.advance`` on :class:`Shards`) with ``force(ps)``
        plus the hook, which sees the substep-entry velocity. ``dt``: a
        Python float, or one 0-dim tensor a shard."""
        vel0 = self.vel

        def force_at(ps):
            acc = force(ps)
            if extra_force is not None:
                acc = [a + forces.checked_extra_acc(extra_force, p, v)
                       * m[:, None]
                       for a, p, v, m in zip(acc, ps, vel0, self.valid)]
            return Shards(acc)

        pos, vel, acc = integrators.advance(
            self.config.integrator, force_at, Shards(self.pos),
            Shards(self.vel), dt if isinstance(dt, float) else Shards(dt))
        self.pos, self.vel, self.acc = list(pos), list(vel), list(acc)

    # -- the ring backends ---------------------------------------------

    def _substep(self, dts: list, extra_force=None) -> None:
        """One substep of the integrator with each shard's dt in ``dts``
        (Python floats, or 0-dim tensors on the shards' devices). Fused
        through the hop kernel's epilogue on "cuda_ring" when dt is a float
        and there is no hook; else the ring's force, the hook, and the
        integration in PyTorch. On "pm" and "p3m" one collective substep
        ("p3m": fresh bins)."""
        if self.ring is None:
            force = (self._pm_force() if self.force_backend == "pm" else
                     self._p3m_force(self._p3m_bins(self.pos, None)))
            self._mesh_substep(dts[0] if isinstance(dts[0], float) else dts,
                               force, extra_force)
            return
        ws = integrators.stage_weights(self.config.integrator)
        fused = (self.force_backend == "cuda_ring" and extra_force is None
                 and isinstance(dts[0], float))
        vel0 = self.vel
        for w in (1.0,) if ws is None else ws:
            self._stage([integrators.stage_dt(w, dt) for dt in dts],
                        dkd=ws is not None, fused=fused,
                        extra_force=extra_force, vel0=vel0)

    def _stage(self, dts: list, *, dkd: bool, fused: bool, extra_force,
               vel0) -> None:
        """One force evaluation and its integration: a whole Euler substep,
        or one drift-kick-drift stage whose force is taken at the midpoint.
        The hook sees the substep-entry velocity ``vel0``."""
        ring, cfg = self.ring, self.config
        pos_in = self.pos
        if dkd:
            pos_in = []
            for k in range(len(self.mesh)):
                with ring.on(k):
                    pos_in.append(self.pos[k] + (0.5 * dts[k]) * self.vel[k])
        if fused:
            self.pos, self.vel, self.acc = ring_substep(
                ring, dts[0], pos_in, self.vel, self.radius, self.valid,
                precise=cfg.precise, pos_dt=0.5 if dkd else 1.0)
            return
        acc = ring_force(ring, pos_in, self.radius, self.valid,
                         precise=cfg.precise, backend=self.force_backend)
        pos, vel = [], []
        for k in range(len(self.mesh)):
            with ring.on(k):
                if extra_force is not None:
                    acc[k] = acc[k] + forces.checked_extra_acc(
                        extra_force, pos_in[k], vel0[k]) * self.valid[k][:, None]
                dt = dts[k]
                vel.append(self.vel[k] + dt * acc[k])
                pos.append(pos_in[k] + (0.5 * dt if dkd else dt) * vel[k])
        self.pos, self.vel, self.acc = pos, vel, acc

    @property
    def particles(self) -> Particles:
        """The first N rows in shard order, as CPU tensors (partitioned
        order, as ``World.particles``). Cached until the next update.
        Raises over a group of several ranks."""
        self._whole("particles")
        if self._host_cache is None:
            n = self.total_len

            def gather(xs):
                return torch.cat([x.to("cpu", copy=True) for x in xs])[:n]

            self._host_cache = Particles(
                pos=gather(self.pos), vel=gather(self.vel),
                acc=gather(self.acc), mass=gather(self.mass),
                radius=gather(self.radius))
        return self._host_cache

    def block_until_ready(self) -> "ShardedWorld":
        if self.ring is not None:
            self.ring.synchronize()
            return self
        for dev in dict.fromkeys(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def __len__(self) -> int:
        return self.total_len
