"""Physics diagnostics on the state's device: momentum, energy, center of
mass, the adaptive-dt criterion. Counterpart of ``nbody_tpu/diagnostics.py``.

Plain PyTorch throughout: ``nbody_tpu`` has no Pallas kernel here, so the
port has no CUDA kernel either. Each function returns a tensor on the
state's device (0-dim for a scalar) and waits for nothing; ``summary``
reads the numbers back to the host. The potential energy is O(N·M), in
chunks of targets that keep one (chunk, M) temporary at
``forces.CHUNK_ELEMS`` elements, as ``forces.direct_sum_acc`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import forces
from .ops.pm_forces import _box, _cic_scatter, _cic_weights
from .types import DTYPE, G, SOFTENING_FLOOR, Particles


def total_momentum(state: Particles) -> torch.Tensor:
    """Sum of m·v, shape (2,). Conserved up to the asymmetric softening."""
    return torch.sum(state.mass[:, None] * state.vel, dim=0)


def center_of_mass(state: Particles) -> torch.Tensor:
    m = torch.sum(state.mass)
    return (torch.sum(state.mass[:, None] * state.pos, dim=0)
            / torch.clamp(m, min=1e-30))


def kinetic_energy(state: Particles) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass * torch.sum(state.vel * state.vel, dim=1))


def potential_energy(state: Particles, mass_len: int, *,
                     chunk: int | None = None, g: float = G) -> torch.Tensor:
    """Softened potential with the reference's (asymmetric) softening:
    U = -G/2 · sum_i sum_{j<mass_len, j!=i} m_i m_j / sqrt(d_ij² + r_i).
    Every nonzero term has a massive target, so each massive pair is
    counted from both ends, hence the uniform 1/2. The self-term is left
    out by index; ``SOFTENING_FLOOR`` is added to the radius, so a
    coincident pair with a radius-0 target gives no 0 divide. ``chunk``
    targets at a time (None: the chunk of ``forces.direct_sum_acc``)."""
    n = state.pos.shape[0]
    device = state.pos.device
    src_pos = state.pos[:mass_len]
    src_m = state.mass[:mass_len]
    if chunk is None:
        chunk = max(1, forces.CHUNK_ELEMS // max(mass_len, 1))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cols = torch.arange(mass_len, device=device)
    total = torch.zeros((), dtype=DTYPE, device=device)
    for i in range(0, n, chunk):
        tpos = state.pos[i:i + chunk]
        trad = state.radius[i:i + chunk] + SOFTENING_FLOOR
        tm = state.mass[i:i + chunk]
        dx = src_pos[None, :, 0] - tpos[:, None, 0]
        dy = src_pos[None, :, 1] - tpos[:, None, 1]
        r = forces.sqrt(dx * dx + dy * dy + trad[:, None])
        rows = torch.arange(i, i + tpos.shape[0], device=device)
        inv = torch.where(rows[:, None] == cols[None, :], 0.0, 1.0 / r)
        total = total + (-0.5 * g) * torch.sum(tm[:, None] * src_m[None, :] * inv)
    return total


def total_energy(state: Particles, mass_len: int, **kw) -> torch.Tensor:
    return kinetic_energy(state) + potential_energy(state, mass_len, **kw)


def angular_momentum(state: Particles) -> torch.Tensor:
    """Scalar z-angular momentum about the origin, L = sum m (x·vy - y·vx);
    conserved by the pair force up to the asymmetric softening."""
    x, y = state.pos[:, 0], state.pos[:, 1]
    vx, vy = state.vel[:, 0], state.vel[:, 1]
    return torch.sum(state.mass * (x * vy - y * vx))


def summary(world) -> dict:
    """Host-side diagnostic snapshot of a World."""
    st = world.state.slice_to(world.total_len)
    return {
        "n": world.total_len,
        "mass_len": world.mass_len,
        "momentum": tuple(float(x) for x in total_momentum(st)),
        "angular_momentum": float(angular_momentum(st)),
        "center_of_mass": tuple(float(x) for x in center_of_mass(st)),
        "kinetic_energy": float(kinetic_energy(st)),
        "potential_energy": float(potential_energy(st, world.mass_len)),
        "suggested_dt": float(suggest_dt(st)),
    }


def observables_capture(mass_len: int, *, energy: str | None = "exact",
                        pe_chunk: int | None = None, pm_grid: int = 512,
                        pm_softening: float = 2.0):
    """A per-frame capture function ``(Particles, gm) -> dict`` of the
    conserved quantities: ``kinetic``, ``momentum`` (2,),
    ``angular_momentum``, ``center_of_mass`` (2,) and, unless ``energy`` is
    None, ``potential``: the O(N·M) pair sum (``"exact"``) or the mesh
    estimate (``"pm"``)."""
    if energy not in (None, "exact", "pm"):
        raise ValueError(f"energy must be None|'exact'|'pm', got {energy!r}")

    def capture(st: Particles, gm) -> dict:
        del gm  # mass changes (merging) are reflected in st.mass already
        out = {
            "kinetic": kinetic_energy(st),
            "momentum": total_momentum(st),
            "angular_momentum": angular_momentum(st),
            "center_of_mass": center_of_mass(st),
        }
        if energy == "exact":
            out["potential"] = potential_energy(st, mass_len, chunk=pe_chunk)
        elif energy == "pm":
            out["potential"] = potential_energy_pm(
                st, mass_len, grid=pm_grid, softening=pm_softening)
        return out

    return capture


def check_observables_args(capture, energy, capture_kw) -> None:
    """Validate the ``record_observables`` argument contract: a custom
    ``capture`` replaces the default observable set entirely, so a
    non-default ``energy`` or stray :func:`observables_capture` kwargs
    alongside it would be silently ignored; reject them instead."""
    if capture is not None and (capture_kw or energy != "exact"):
        raise ValueError(
            "a custom capture replaces the default observables entirely; "
            f"energy={energy!r} / extra kwargs {sorted(capture_kw)} would be "
            "silently ignored — drop them or drop capture")


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def observables_series_out(series, frames: int, steps_per_frame: int,
                           dt: float) -> dict:
    """Captured series (tensors, or dicts and sequences of them) -> the
    host dict of numpy arrays, with the synthesized ``"time"`` axis
    appended. A capture that already produced a ``"time"`` key is rejected
    rather than silently overwritten."""
    series = _to_numpy(series)
    out = dict(series) if isinstance(series, dict) else {"capture": series}
    if "time" in out:
        raise ValueError(
            "capture returned a 'time' key, which collides with the "
            "synthesized time axis — rename it")
    out["time"] = (np.arange(1, frames + 1, dtype=np.float64)
                   * steps_per_frame * dt)
    return out


def timescale(acc: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """min_i sqrt(eps_i / |a_i|) with eps_i = sqrt(radius_i) over the rows
    with nonzero acceleration, +inf if there is none; 0-dim, on ``acc``'s
    device. A sharded world takes the min of its shards' values."""
    a = forces.sqrt(torch.sum(acc * acc, dim=1))
    t = torch.where(a > 0, forces.sqrt(forces.sqrt(radius)
                                       / torch.clamp(a, min=1e-30)),
                    float("inf"))
    return torch.amin(t)


def criterion_dt(acc: torch.Tensor, radius: torch.Tensor, eta) -> torch.Tensor:
    """The softening-resolution criterion: eta · :func:`timescale`; +inf
    for a force-free world. The one definition that :func:`suggest_dt` and
    every adaptive loop of the port call. ``eta`` is a float or a 0-dim
    fp32 tensor."""
    return eta * timescale(acc, radius)


def clip_dt(crit, *, dt_min, dt_max, t, t_span):
    """The criterion ``crit`` clipped to [max(dt_min, 1e-9), dt_max]
    (floored away from 0 so the loop always ends) and shrunk to land
    exactly on ``t_span`` from the elapsed time ``t``. Knobs are floats or
    0-dim fp32 tensors on ``crit``'s device."""
    def f32(x):
        return torch.as_tensor(x, dtype=DTYPE, device=crit.device)

    lo = torch.clamp(f32(dt_min), min=1e-9)
    dt = torch.minimum(torch.maximum(crit, lo), f32(dt_max))
    return torch.minimum(dt, f32(t_span) - t)


def next_adaptive_dt(acc, radius, *, eta, dt_min, dt_max, t, t_span):
    """One adaptive-loop dt choice: :func:`clip_dt` of
    :func:`criterion_dt`."""
    return clip_dt(criterion_dt(acc, radius, eta), dt_min=dt_min,
                   dt_max=dt_max, t=t, t_span=t_span)


def suggest_dt(state: Particles, *, eta: float = 0.1) -> torch.Tensor:
    """Global timestep suggestion from the state's stored ``acc`` (valid
    after any substep): :func:`criterion_dt`, +inf for a force-free
    world."""
    return criterion_dt(state.acc, state.radius, eta)


def potential_energy_pm(state: Particles, mass_len: int, *, grid: int = 512,
                        softening: float = 2.0, g: float = G) -> torch.Tensor:
    """Mesh-estimated potential energy, O(N + G² log G), the scalable
    companion of :func:`potential_energy`: CIC-scatter the massive rows to
    a (G, G) mass grid, free-space-convolve with the even kernel
    1/sqrt(r² + eps²), CIC-gather phi back at the massive rows,
    U = -1/2 sum m_i phi_i. The mesh includes each particle's interaction
    with its own CIC cloud; that self-term is removed exactly in the
    discrete sense: per particle gm·(wᵀ K w) over the 4 corner weights w
    and the 4x4 corner-offset kernel table K (entries 1/eps,
    1/sqrt(h² + eps²), 1/sqrt(2h² + eps²)). Pairs closer than ~2-3 cells
    are smoothed to the global ``softening`` instead of the per-target
    radius, as in the pm force path."""
    device = state.pos.device
    if mass_len == 0:
        return torch.zeros((), dtype=DTYPE, device=device)
    pos = state.pos[:mass_len]
    m = state.mass[:mass_len]
    gm = g * m
    real = (gm != 0.0)[:, None]
    s_min = torch.where(real, pos, float("inf")).amin(dim=0)
    s_max = torch.where(real, pos, float("-inf")).amax(dim=0)
    lo, h = _box(s_min, s_max, grid)
    inv_h = 1.0 / h
    eps2 = torch.as_tensor(softening, dtype=DTYPE, device=device) ** 2

    rho = _cic_scatter(pos, gm, lo, inv_h, grid)

    # free-space phi kernel (even): phi = -conv(rho, 1/sqrt(r² + eps²))
    n2 = 2 * grid
    idx = torch.arange(n2, device=device)
    d = torch.where(idx < grid, idx, idx - n2).to(DTYPE)
    dx = d[:, None] * h
    dy = d[None, :] * h
    k_phi = torch.rsqrt(dx * dx + dy * dy + eps2)
    rho_pad = torch.zeros((n2, n2), dtype=DTYPE, device=device)
    rho_pad[:grid, :grid] = rho
    phi = -torch.fft.irfft2(torch.fft.rfft2(rho_pad) * torch.fft.rfft2(k_phi),
                            s=(n2, n2))[:grid, :grid]

    # CIC gather of phi at the massive rows
    i0, j0, wx, wy = _cic_weights(pos, lo, inv_h, grid)
    w4 = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                      (1 - wx) * wy, wx * wy], dim=-1)          # (M, 4)
    phi_i = (w4[:, 0] * phi[i0, j0] + w4[:, 1] * phi[i0 + 1, j0]
             + w4[:, 2] * phi[i0, j0 + 1] + w4[:, 3] * phi[i0 + 1, j0 + 1])

    # exact discrete self-term: corner offsets are 0, h or h·sqrt(2)
    ks = torch.stack([torch.rsqrt(eps2), torch.rsqrt(h * h + eps2),
                      torch.rsqrt(2 * h * h + eps2)])
    kmat = torch.tensor([[0, 1, 1, 2], [1, 0, 2, 1], [1, 2, 0, 1],
                         [2, 1, 1, 0]], device=device)
    ktab = ks[kmat]                                              # (4, 4)
    # elementwise, not einsum: no matmul, so no TF32 on the card
    self_phi = -gm * torch.sum(w4[:, :, None] * ktab * w4[:, None, :],
                               dim=(1, 2))
    return 0.5 * torch.sum(m * (phi_i - self_phi))
