"""Direct-sum softened gravity in plain PyTorch: the port's oracle and the
"torch" backend. Counterpart of ``nbody_tpu/forces.py``.

The math is the reference's (sim_cpu.c:156-194, particle_cs.glsl:35-49):

  radv    = pos_source - pos_target
  r2      = dot(radv, radv) + (radius_target + SOFTENING_FLOOR)
  acc    += radv * (G * m_source / (sqrt(r2) * r2))

``precise=True`` is sqrt and divide, as the shader writes it; ``False`` is
rsqrt cubed. Only the sources handed in (the massive prefix) exert force;
self-interaction contributes zero because radv == 0.
"""

from __future__ import annotations

import torch

from .types import SOFTENING_FLOOR

# Elements of one (chunk, S) temporary in ``direct_sum_acc``: 2**25 fp32 is
# 128 MiB, and one chunk holds about eight such temporaries alive at once,
# so a chunk stays near 1 GiB of device memory whatever S is.
CHUNK_ELEMS = 1 << 25


def pair_acc(
    tgt_pos: torch.Tensor,
    tgt_radius: torch.Tensor,
    src_pos: torch.Tensor,
    src_gm: torch.Tensor,
    *,
    precise: bool = True,
) -> torch.Tensor:
    """Acceleration on each target from all sources, O(T*S) dense.

    tgt_pos (T, 2), tgt_radius (T,), src_pos (S, 2), src_gm (S,) = G * mass.
    Returns (T, 2) in the inputs' dtype.
    """
    dx = src_pos[None, :, 0] - tgt_pos[:, None, 0]
    dy = src_pos[None, :, 1] - tgt_pos[:, None, 1]
    dist_sq = dx * dx + dy * dy
    r2 = dist_sq + (tgt_radius + SOFTENING_FLOOR)[:, None]
    if precise:
        f = src_gm[None, :] / (torch.sqrt(r2) * r2)
    else:
        inv = torch.rsqrt(r2)
        f = src_gm[None, :] * (inv * inv * inv)
    ax = torch.sum(dx * f, dim=1)
    ay = torch.sum(dy * f, dim=1)
    return torch.stack([ax, ay], dim=-1)


def direct_sum_acc(
    pos: torch.Tensor,
    radius: torch.Tensor,
    src_pos: torch.Tensor,
    src_gm: torch.Tensor,
    *,
    chunk: int | None = None,
    precise: bool = True,
) -> torch.Tensor:
    """Direct-sum acceleration over target chunks.

    Each chunk of ``chunk`` targets meets all sources at once, so memory is
    O(chunk * S). ``None`` picks the chunk that keeps one (chunk, S)
    temporary at ``CHUNK_ELEMS``. The last chunk may be short.
    """
    n = pos.shape[0]
    if chunk is None:
        chunk = max(1, CHUNK_ELEMS // max(src_pos.shape[0], 1))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if chunk >= n:
        return pair_acc(pos, radius, src_pos, src_gm, precise=precise)
    return torch.cat([
        pair_acc(pos[i:i + chunk], radius[i:i + chunk], src_pos, src_gm,
                 precise=precise)
        for i in range(0, n, chunk)
    ])


def integrate(pos, vel, acc, dt: float):
    """Semi-implicit (symplectic) Euler, velocity first (sim_cpu.c:192-193,
    particle_cs.glsl:51-52): v += a*dt; x += v*dt."""
    vel = vel + dt * acc
    pos = pos + dt * vel
    return pos, vel
