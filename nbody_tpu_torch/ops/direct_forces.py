"""Direct-sum force and fused substep: the CUDA kernel's wrappers, each with
its plain PyTorch version beside it.

Counterparts of ``fused_substep`` and ``pallas_acc`` in
``nbody_tpu/ops/pallas_forces.py``. One kernel, ``csrc/direct_forces.cu``,
replaces both TPU kernels there (``_substep_kernel`` with resident sources
and ``_stream_kernel`` with streamed ones): it stages sources through shared
memory tile by tile, masks its own ragged edges, and reads sources straight
from ``pos[:S]`` and ``gm``.

``force_acc`` splits the source sum over several blocks when its targets
alone cannot fill the card (:func:`_split_plan`); ``fused_substep`` always
makes one launch, since the main path's N fills the card by itself.

Dispatch is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, and anything wrong there raises.
Nothing falls back from the kernel to the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import forces

# The kernel's threads per block (= targets per block) and sources per
# shared-memory tile (csrc/direct_forces.cu kBlock, kTile).
BLOCK = 256
TILE = 256

# Kernel launches made by the wrappers in this process (plain-version calls
# are not counted). A run resets it to 0 and reads it back to show which
# path it took.
LAUNCHES = 0


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
                 precise, acc, pos_out, vel_out) -> tuple:
    """Arguments of the C entry point ``nbody_direct_forces``, stream aside.
    The source count is len(src_gm): ``src_pos`` may hold more rows (the
    fused substep passes all of ``pos`` and reads its first S rows)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    return (tgt_pos.data_ptr(), ptr(tgt_vel), tgt_radius.data_ptr(),
            src_pos.data_ptr(), src_gm.data_ptr(),
            tgt_pos.shape[0], src_gm.shape[0], float(dt), float(pos_dt),
            int(precise), int(pos_out is not None),
            acc.data_ptr(), ptr(pos_out), ptr(vel_out))


def _lib():
    from . import _build

    return _build.load("direct_forces")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch(*args) -> None:
    """Launch the kernel on the current stream of the targets' device with
    the arguments of :func:`_kernel_args`; raise if the launch failed."""
    global LAUNCHES
    with torch.cuda.device(args[0].device):
        err = _lib().nbody_direct_forces(
            *_kernel_args(*args), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "direct_forces")
    LAUNCHES += 1


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``
    (cudaDeviceGetAttribute, read once per device)."""
    import ctypes

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().nbody_sm_count(ctypes.addressof(out)), "sm count")
    return out.value


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
    """Number of source ranges ``force_acc`` cuts its sum into for T targets,
    S sources on a card of ``sms`` SMs (:func:`split_ranges` over blocks of
    256 targets and tiles of 256 sources)."""
    return split_ranges(-(-t // BLOCK), -(-s // TILE), sms)


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
) -> torch.Tensor:
    """(T, 2) fp32 accelerations of every target from all S sources (the
    ``pallas_acc`` counterpart). Any T and S, S = 0 included. On the card,
    few targets against many sources take the source-split launch
    (:func:`_split_plan`); either way it counts as one launch."""
    device = _device_of(tgt_pos)
    t, s = tgt_pos.shape[0], src_pos.shape[0]
    _check("tgt_pos", tgt_pos, (t, 2), device)
    _check("tgt_radius", tgt_radius, (t,), device)
    _check("src_pos", src_pos, (s, 2), device)
    _check("src_gm", src_gm, (s,), device)
    if device.type == "cpu":
        return force_acc_plain(tgt_pos, tgt_radius, src_pos, src_gm,
                               precise=precise)
    acc = torch.empty((t, 2), dtype=torch.float32, device=device)
    n_split = _split_plan(t, s, sm_count(device.index
                                         if device.index is not None
                                         else torch.cuda.current_device()))
    if n_split == 1:
        _launch(tgt_pos, None, tgt_radius, src_pos, src_gm, 0.0, 1.0,
                precise, acc, None, None)
        return acc
    global LAUNCHES
    partial = torch.empty((n_split, t, 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _lib().nbody_direct_forces_split(
            tgt_pos.data_ptr(), tgt_radius.data_ptr(), src_pos.data_ptr(),
            src_gm.data_ptr(), t, s, n_split, int(precise),
            partial.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "direct_forces (source split)")
    LAUNCHES += 1
    return acc


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
):
    """One substep, force and integration, in one kernel launch (the
    ``fused_substep`` counterpart).

    Sources are the first S = len(gm) rows of ``pos``. ``pos_dt=1.0`` is
    the reference's semi-implicit Euler (v += a*dt; x += v*dt); ``0.5`` is
    the kick and half-drift of a DKD stage. ``dt`` is a Python float, so
    the call makes no host sync. Returns new (pos, vel, acc), each (N, 2),
    in fresh buffers: the inputs are not modified.
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
    acc = torch.empty((n, 2), dtype=torch.float32, device=device)
    npos = torch.empty_like(acc)
    nvel = torch.empty_like(acc)
    _launch(pos, vel, radius, pos, gm, dt, pos_dt, precise, acc, npos, nvel)
    return npos, nvel, acc
