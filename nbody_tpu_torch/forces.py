"""Direct-sum softened gravity in plain PyTorch: the port's oracle and the
"torch" backend. Counterpart of ``nbody_tpu/forces.py``.

The math is the reference's (sim_cpu.c:156-194, particle_cs.glsl:35-49):

  radv    = pos_source - pos_target
  r2      = dot(radv, radv) + (radius_target + SOFTENING_FLOOR)
  acc    += radv * (G * m_source / (sqrt(r2) * r2))

``precise=True`` is sqrt and divide, as the shader writes it; ``False`` is
rsqrt cubed. Only the sources handed in (the massive prefix) exert force;
self-interaction contributes zero because radv == 0.

Every square root of the port's plain code goes through :func:`sqrt`,
which is correctly rounded on the CPU as on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import DTYPE, G, SOFTENING_FLOOR

# Elements of one (chunk, S) temporary in ``direct_sum_acc``: 2**25 fp32 is
# 128 MiB, and one chunk holds about eight such temporaries alive at once,
# so a chunk stays near 1 GiB of device memory whatever S is.
CHUNK_ELEMS = 1 << 25


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (``jnp.sqrt``'s), on any device.

    On CUDA tensors this is ``torch.sqrt``. On the CPU, PyTorch's float
    sqrt calls MKL's vector sqrt (VML, high-accuracy mode) on each worker
    thread's share of the elements: within 1 ulp, not correctly rounded,
    and on the first call of a process it sometimes computes one thread's
    share to about 12 bits (3.3e-4 relative). numpy's sqrt is the IEEE
    instruction, elementwise and single-threaded, so the CPU takes it."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    np.sqrt(x.numpy(), out=out.numpy())
    return out


def add_at(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> None:
    """dst[index[k]] += src[k] in place, for every k in row order (rows of
    a 2-D ``dst``): the serial scatter-add of XLA's CPU backend, with the
    same bits. On the CPU, ``scatter_add_`` of each column runs serially
    (``index_put_`` with accumulate there adds by float atomics across
    threads once it has 32768 entries, in an order that varies from run to
    run); on the card, ``index_put_(accumulate=True)`` sorts the indices
    stably and sums each destination's entries in order (``index_add_``
    and ``scatter_add_`` add by float atomics there)."""
    if dst.device.type != "cpu":
        dst.index_put_((index,), src, accumulate=True)
        return
    if dst.dim() == 1:
        dst.scatter_add_(0, index, src)
        return
    for k in range(dst.shape[1]):
        col = dst[:, k].contiguous()
        col.scatter_add_(0, index, src[:, k].contiguous())
        dst[:, k] = col


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
        f = src_gm[None, :] / (sqrt(r2) * r2)
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


def acc_from_particles(
    pos: torch.Tensor,
    radius: torch.Tensor,
    mass: torch.Tensor,
    mass_len: int,
    *,
    chunk: int | None = None,
    precise: bool = True,
    g: float = G,
) -> torch.Tensor:
    """Convenience oracle: all particles as targets, the first ``mass_len``
    as sources (the massive-first partition invariant, world.c:33-46)."""
    src_gm = g * mass[:mass_len]
    return direct_sum_acc(pos, radius, pos[:mass_len], src_gm, chunk=chunk,
                          precise=precise)


def checked_extra_acc(extra_force, pos, vel, *params) -> torch.Tensor:
    """Call a user ``extra_force(pos, vel, *params)`` hook and return its
    accelerations as fp32 on ``pos``'s device, or raise ``ValueError``
    unless their shape is ``pos.shape``: ``acc + out`` would broadcast a
    (N, 1) or scalar return silently."""
    out = torch.as_tensor(extra_force(pos, vel, *params), dtype=DTYPE,
                          device=pos.device)
    if out.shape != pos.shape:
        raise ValueError(
            "extra_force must return accelerations with the same shape as "
            f"pos {tuple(pos.shape)}, got {tuple(out.shape)}")
    return out


def integrate(pos, vel, acc, dt: float):
    """Semi-implicit (symplectic) Euler, velocity first (sim_cpu.c:192-193,
    particle_cs.glsl:51-52): v += a*dt; x += v*dt."""
    vel = vel + dt * acc
    pos = pos + dt * vel
    return pos, vel
