"""Particle-space sharding over a list of devices: the ring of source
tiles. Counterpart of ``nbody_tpu/parallel/sharding.py`` for the
direct-sum backends.

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
  * Each force evaluation is one pass round the ring of
    ``ops/ring_forces.py``: the visiting source slot moves one shard per hop
    by a device-to-device copy on a side stream while the shard computes on
    the other slot; CUDA events play the semaphores.

Backends (the port's names for JAX's): "torch" ("jnp") plain per-hop force
then integrate; "cuda" ("pallas") the direct kernel per hop; "cuda_ring"
("pallas_ring") the ring hop kernel K3, whose last hop integrates.

A user field ``extra_force(pos, vel)`` is pointwise per shard: it sees
the shard's rows, its term is masked by ``valid`` and added to the ring's
force, and the integration runs in PyTorch on each shard's stream. So does
the adaptive loop, whose dt is a tensor on the device. On "cuda_ring" such
a substep takes its force from the hop kernel without its epilogue.

Under ``SimConfig.merge_collisions`` every substep is followed by one merge
pass (``ops/collisions.merge_pass``): the ``src_len`` rows of the massive
prefix are gathered from the shards, in global row order, onto the first
shard's device, merged there once, and the changed rows and ``gm_src``
copied back to their shards: the single-controller form of the pass that
nbody_tpu runs on the global sharded arrays. The ring reads the shards' gm
tensors, which the merge updates in place.
"""

from __future__ import annotations

from typing import Literal

import torch

from .. import diagnostics, forces, integrators, world
from ..ops.collisions import merge_pass
from ..ops.ring_forces import Ring, ring_force, ring_substep
from ..trajectory import stack_frames
from ..types import DEFAULT_SIM_CONFIG, DTYPE, Particles, SimConfig, round_up
from ..world import _scalar, partition_massive_first

# Source shards align to 128 rows, as in nbody_tpu
# (nbody_tpu/ops/pallas_forces.py:66). There it is the TPU's lane width; here
# it only fixes the layout, which must equal nbody_tpu's so that shard d
# carries the same sources in both packages. No kernel of the port needs it.
SOURCE_ALIGN = 128

FORCE_BACKENDS = ("torch", "cuda", "cuda_ring")
NOT_PORTED = ("pm", "p3m", "auto")


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


def _resolve_force_backend(force_backend, devices, merging=False) -> str:
    if force_backend is None:
        return "cuda" if devices[0].type == "cuda" else "torch"
    if merging and force_backend == "p3m":
        raise ValueError(
            "merge_collisions is not supported with force_backend='p3m' "
            "(frozen cell blocks); use 'torch', 'cuda' or 'cuda_ring'")
    if force_backend in NOT_PORTED:
        raise NotImplementedError(
            f"force_backend {force_backend!r} on a sharded world is not yet "
            f"ported to nbody_tpu_torch; use one of {FORCE_BACKENDS}")
    if force_backend not in FORCE_BACKENDS:
        raise ValueError(
            f"unknown force_backend {force_backend!r}; expected one of "
            f"{FORCE_BACKENDS}")
    return force_backend


class ShardedWorld:
    """World sharded over a 1-D mesh of devices, with the force computed by
    the ring of source tiles. Mirrors :class:`nbody_tpu_torch.World`:
    create, ``update(dt, n)``, ``particles``.

    Layout: ``n_pad`` = D·``t_loc`` padded rows, shard d holding rows
    [d·t_loc, (d+1)·t_loc); ``src_len`` = D·``s_loc`` source rows, shard d
    owning rows [d·s_loc, (d+1)·s_loc) of the massive prefix and their gm
    (``gm_src``, zero past ``mass_len``). Per-shard state is in the lists
    ``pos``, ``vel``, ``acc``, ``mass``, ``radius`` and ``valid``."""

    def __init__(
        self,
        particles: Particles,
        mesh: list | None = None,
        *,
        config: SimConfig = DEFAULT_SIM_CONFIG,
        force_backend: Literal["torch", "cuda", "cuda_ring"] | None = None,
    ):
        self.mesh = make_mesh(devices=mesh) if mesh is not None else make_mesh()
        d = self.n_devices = len(self.mesh)
        self.config = config
        self.force_backend = _resolve_force_backend(
            force_backend, self.mesh, merging=config.merge_collisions)
        n = particles.pos.shape[0]
        mass_len = int(torch.count_nonzero(particles.mass > 0))
        s_loc, t_loc, src_len, n_pad = shard_layout(n, mass_len, config, d)
        self.total_len, self.mass_len = n, mass_len
        self.s_loc, self.t_loc, self.src_len, self.n_pad = (
            s_loc, t_loc, src_len, n_pad)

        state, gm, valid = padded_state(particles, mass_len, n_pad, config.g)

        def split(x, rows):
            return [x[k * rows:(k + 1) * rows].to(dev).contiguous()
                    for k, dev in enumerate(self.mesh)]

        self.pos, self.vel, self.acc = (split(x, t_loc) for x in
                                        (state.pos, state.vel, state.acc))
        self.mass, self.radius = split(state.mass, t_loc), split(state.radius, t_loc)
        self.valid = split(valid, t_loc)
        self._gm_src = split(gm[:src_len], s_loc)
        self.ring = Ring(self.mesh, t_loc, s_loc, mass_len, self._gm_src,
                         n_targets=n)
        self._host_cache: Particles | None = None

    @property
    def gm_src(self) -> torch.Tensor:
        """The whole (src_len,) source gm row, on the CPU."""
        return torch.cat([g.cpu() for g in self._gm_src])

    def update(self, dt: float, n: int = 1, extra_force=None) -> "ShardedWorld":
        """n substeps of size dt. ``extra_force(pos, vel) -> acc`` composes
        a user acceleration field with self-gravity per shard: a pointwise
        per-particle function, which sees one shard's rows. Under merging,
        each substep is followed by a merge pass. The loop never syncs with
        the host: ``dt`` stays a Python float, and only ``particles`` and
        ``block_until_ready`` wait."""
        if n <= 0:
            return self
        dts = [float(dt)] * self.n_devices
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
        substep merges, as nbody_tpu's does."""
        dev0 = self.mesh[0]
        merging = self.config.merge_collisions
        knobs = {key: _scalar(v, dev0) for key, v in (
            ("dt_min", dt_min), ("dt_max", dt_max), ("t_span", t_span))}
        eta = _scalar(eta, dev0)
        with self.ring.fork():  # prime acc: dt = 0, nothing moves
            self._substep([_scalar(0.0, dev) for dev in self.mesh],
                          extra_force)
        if merging:
            self._merge()
        t = _scalar(0.0, dev0)
        k = torch.zeros((), dtype=torch.int32, device=dev0)
        while True:
            for _ in range(world.ADAPTIVE_BATCH):
                live = t < knobs["t_span"]
                crit = eta * torch.stack([
                    diagnostics.timescale(a, r).to(dev0)
                    for a, r in zip(self.acc, self.radius)]).amin()
                dt = torch.where(live, diagnostics.clip_dt(
                    crit, t=t, **knobs), 0.0)
                old = (self.pos, self.vel, self.acc, self.radius, self.mass)
                lives = [live.to(dev) for dev in self.mesh]
                with self.ring.fork():
                    self._substep([dt.to(dev) for dev in self.mesh],
                                  extra_force)
                    # a substep past the end keeps the old state
                    for j in range(0 if merging else self.n_devices):
                        with self.ring.on(j):
                            for new, prev in zip(
                                    (self.pos, self.vel, self.acc), old):
                                new[j] = torch.where(lives[j], new[j], prev[j])
                if merging:  # masks after the merge, the state's every field
                    self._merge(lives, old)
                t = t + dt
                k = k + live.to(torch.int32)
            if not world._host(t < knobs["t_span"]):
                break
        self._host_cache = None
        return world._host(k)

    def _merged(self) -> tuple:
        """Per-shard (pos, vel, radius, mass, gm_src) lists after one merge
        pass over the massive prefix, run once on the first shard's device;
        the world's own lists are not modified."""
        dev0 = self.mesh[0]
        # (shard k, rows): rows [k·t_loc, k·t_loc + rows) of the src_len
        # prefix rows lie in shard k
        pieces = [(k, min(self.t_loc, self.src_len - k * self.t_loc))
                  for k in range(self.n_devices)
                  if k * self.t_loc < self.src_len]

        def gather(xs):
            return torch.cat([xs[k][:rows].to(dev0) for k, rows in pieces])

        out = merge_pass(gather(self.pos), gather(self.vel),
                         gather(self.radius), gather(self.mass),
                         torch.cat([g.to(dev0) for g in self._gm_src]),
                         factor=self.config.merge_factor, g=self.config.g)
        lists = []
        for xs, merged in zip((self.pos, self.vel, self.radius, self.mass),
                              out[:4]):
            new, lo = list(xs), 0
            for k, rows in pieces:
                new[k] = torch.cat([merged[lo:lo + rows].to(self.mesh[k]),
                                    xs[k][rows:]])
                lo += rows
            lists.append(new)
        s = self.s_loc
        gms = [out[4][k * s:(k + 1) * s].to(dev)
               for k, dev in enumerate(self.mesh)]
        return (*lists, gms)

    def _merge(self, lives=None, old=None) -> None:
        """Apply one merge pass; with ``lives`` (a 0-dim bool per shard) and
        ``old`` (the pre-substep pos, vel, acc, radius, mass lists), a shard
        whose flag is False keeps ``old`` and its gm. The shards' gm tensors
        are updated in place, where the ring reads them."""
        pos, vel, radius, mass, gms = self._merged()
        acc = self.acc
        if lives is not None:
            def keep(new, prev):
                return [torch.where(f, a, b) for f, a, b in zip(lives, new, prev)]
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

    @property
    def state(self) -> Particles:
        """The padded state (``n_pad`` rows, shard order) gathered onto the
        first shard's device: the same view as ``World.state``, for
        diagnostics and checks."""
        dev0 = self.mesh[0]

        def cat(xs):
            return torch.cat([x.to(dev0) for x in xs])

        return Particles(pos=cat(self.pos), vel=cat(self.vel),
                         acc=cat(self.acc), mass=cat(self.mass),
                         radius=cat(self.radius))

    def _substep(self, dts: list, extra_force=None) -> None:
        """One substep of the integrator with each shard's dt in ``dts``
        (Python floats, or 0-dim tensors on the shards' devices). Fused
        through the hop kernel's epilogue on "cuda_ring" when dt is a float
        and there is no hook; else the ring's force, the hook, and the
        integration in PyTorch."""
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
            for k in range(self.n_devices):
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
        for k in range(self.n_devices):
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
        order, as ``World.particles``). Cached until the next update."""
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
        self.ring.synchronize()
        return self

    def __len__(self) -> int:
        return self.total_len
