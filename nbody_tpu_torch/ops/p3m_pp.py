"""P³M pair correction over packed cell blocks: the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``pp_blocks`` in ``nbody_tpu/ops/p3m_pallas.py`` (the Pallas
kernel ``_pp_kernel`` and its jnp twin ``_pp_blocks_jnp``). In the JAX
package that kernel is a tested alternative and the production PP stage is
an XLA map; in the port, ``csrc/p3m_pp.cu`` is the PP stage on the card.

Each target slot of cell (i, j) meets every source slot of the 3×3
neighbour cells; for pairs with d² < rc² it adds
``gm · (exact³ − taper(d/rc) · smooth³) · (dx, dy)``, the exact softened
force minus what the tapered mesh already delivered. Neighbours outside the
grid contribute nothing. Both versions form the taper's u as
``sqrt(d² + 1e-12) · (1/rc)``, with 1/rc rounded in fp32 as the Pallas
kernel's caller forms it. ``rc`` and ``eps2`` may be Python floats or 0-dim
tensors on the blocks' device (the p3m path's rc follows the adaptive box):
the kernel reads them from device memory, so no call waits for the host.

Dispatch is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, and anything wrong there raises.
"""

from __future__ import annotations

import torch

from ..types import DTYPE, SOFTENING_FLOOR

# Kernel launches made by ``pp_blocks`` in this process (plain-version calls
# are not counted). A run resets it to 0 and reads it back.
LAUNCHES = 0

# Elements of one (cells, cap_t, 9·cap_s) pair temporary in the plain
# version: 2**24 fp32 is 64 MiB, and about ten such temporaries are alive
# at once.
PLAIN_CHUNK_ELEMS = 1 << 24


def _scalars(rc, eps2, device) -> torch.Tensor:
    """(3,) fp32 on ``device``: rc, eps2 and 1/rc formed in fp32."""
    rc = torch.as_tensor(rc, dtype=DTYPE, device=device)
    eps2 = torch.as_tensor(eps2, dtype=DTYPE, device=device)
    return torch.stack([rc, eps2, 1.0 / rc])


def _neighbour_cells(cells: torch.Tensor, gc: int) -> torch.Tensor:
    """(len(cells), 9) flat indices of each cell's 3×3 neighbours in the
    (gc+2)² zero-ringed grid, row offset outer, column offset inner (the
    order in which ``_pp_blocks_jnp`` concatenates them)."""
    i = cells // gc
    j = cells % gc
    off = torch.arange(3, device=cells.device)
    rows = (i[:, None] + off[None, :])[:, :, None]
    cols = (j[:, None] + off[None, :])[:, None, :]
    return (rows * (gc + 2) + cols).reshape(-1, 9)


def _slot_mask(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(gc², cap) bool: slot k of cell c is below min(counts[c], cap)."""
    slot = torch.arange(cap, device=counts.device)
    return slot[None, :] < counts.reshape(-1, 1)


def pp_blocks_plain(tx, ty, tr, sx, sy, sg, rc, eps2, *, precise: bool = False,
                    counts_t=None, counts_s=None) -> torch.Tensor:
    """Plain version of :func:`pp_blocks`, computed a chunk of cells at a
    time (memory O(chunk · cap_t · 9 cap_s)). With ``counts_t`` only cells
    that hold targets are computed; finding them reads the counts on the
    host."""
    gc, _, cap_t = tx.shape
    cap_s = sx.shape[-1]
    rc, eps2, inv_rc = _scalars(rc, eps2, tx.device)
    rc2 = rc * rc
    tr = tr + SOFTENING_FLOOR
    if counts_s is not None:
        sg = torch.where(_slot_mask(counts_s, cap_s).reshape(sg.shape), sg, 0.0)
    pad = [torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1)).reshape(-1, cap_s)
           for a in (sx, sy, sg)]
    txf, tyf, trf = (a.reshape(gc * gc, cap_t) for a in (tx, ty, tr))
    out = torch.zeros((gc * gc, cap_t, 2), dtype=DTYPE, device=tx.device)
    if counts_t is None:
        todo = torch.arange(gc * gc, device=tx.device)
    else:
        todo = torch.nonzero(counts_t.reshape(-1) > 0).reshape(-1)
    chunk = max(1, PLAIN_CHUNK_ELEMS // (cap_t * 9 * cap_s))
    for c0 in range(0, todo.shape[0], chunk):
        cells = todo[c0:c0 + chunk]
        nb = _neighbour_cells(cells, gc)
        nsx, nsy, nsg = (p[nb].reshape(len(cells), 9 * cap_s) for p in pad)
        dx = nsx[:, None, :] - txf[cells][:, :, None]   # (m, cap_t, 9 cap_s)
        dy = nsy[:, None, :] - tyf[cells][:, :, None]
        d2 = dx * dx + dy * dy
        r2 = d2 + trf[cells][:, :, None]
        q2 = d2 + eps2
        if precise:
            exact3 = 1.0 / (torch.sqrt(r2) * r2)
            smooth3 = 1.0 / (torch.sqrt(q2) * q2)
        else:
            inv = torch.rsqrt(r2)
            exact3 = inv * inv * inv
            invq = torch.rsqrt(q2)
            smooth3 = invq * invq * invq
        u = torch.clamp(torch.sqrt(d2 + 1e-12) * inv_rc, max=1.0)
        taper = u * u * u * (10.0 + u * (6.0 * u - 15.0))
        w = nsg[:, None, :] * (exact3 - taper * smooth3)
        w = torch.where(d2 < rc2, w, 0.0)
        out[cells, :, 0] = (w * dx).sum(-1)
        out[cells, :, 1] = (w * dy).sum(-1)
    if counts_t is not None:
        out = out * _slot_mask(counts_t, cap_t)[..., None]
    return out


def _check_blocks(blocks, counts, device):
    (tx, ty, tr), (sx, sy, sg) = blocks
    gc, gc2, cap_t = tx.shape
    if gc != gc2 or sx.shape[:2] != tx.shape[:2]:
        raise ValueError(f"blocks must be (gc, gc, cap), got {tuple(tx.shape)} "
                         f"and {tuple(sx.shape)}")
    for name, a, shape in (("tx", tx, tx.shape), ("ty", ty, tx.shape),
                           ("tr", tr, tx.shape), ("sx", sx, sx.shape),
                           ("sy", sy, sx.shape), ("sg", sg, sx.shape)):
        if not isinstance(a, torch.Tensor) or a.dtype != DTYPE:
            raise TypeError(f"{name} must be a float32 tensor")
        if a.shape != shape or a.device != device or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                             f"tensor on {device}")
    for name, c in counts.items():
        if c is not None and (c.dtype != torch.int32 or c.numel() != gc * gc
                              or c.device != device or not c.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"gc² = {gc * gc} cells on {device}")


def pp_blocks(
    tx: torch.Tensor, ty: torch.Tensor, tr: torch.Tensor,  # (gc, gc, cap_t)
    sx: torch.Tensor, sy: torch.Tensor, sg: torch.Tensor,  # (gc, gc, cap_s)
    rc: float | torch.Tensor, eps2: float | torch.Tensor, *,
    precise: bool = False,
    counts_t: torch.Tensor | None = None,   # (gc²,) int32 targets per cell
    counts_s: torch.Tensor | None = None,   # (gc²,) int32 sources per cell
) -> torch.Tensor:
    """Per-slot P³M pair correction of packed target cell blocks against
    packed source cell blocks: (gc², cap_t, 2) fp32. Adds SOFTENING_FLOOR to
    ``tr`` as ``nbody_tpu``'s ``pp_blocks`` does. The call makes no host
    sync.

    Without the counts every slot is computed (the JAX ``pp_blocks``
    semantics). With ``counts_t``, slots at or beyond a cell's count are
    zero; with ``counts_s``, only a cell's first ``counts_s`` source slots
    are read (the others must hold gm = 0, as packed blocks do)."""
    device = tx.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"p3m_pp runs on CPU or CUDA tensors, got {device}")
    _check_blocks(((tx, ty, tr), (sx, sy, sg)),
                  {"counts_t": counts_t, "counts_s": counts_s}, device)
    if device.type == "cpu":
        return pp_blocks_plain(tx, ty, tr, sx, sy, sg, rc, eps2,
                               precise=precise, counts_t=counts_t,
                               counts_s=counts_s)
    global LAUNCHES
    from . import _build

    gc, _, cap_t = tx.shape
    cap_s = sx.shape[-1]
    scal = _scalars(rc, eps2, device)
    tr = tr + SOFTENING_FLOOR
    out = torch.empty((gc * gc, cap_t, 2), dtype=DTYPE, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        err = _build.load("p3m_pp").nbody_p3m_pp(
            tx.data_ptr(), ty.data_ptr(), tr.data_ptr(), sx.data_ptr(),
            sy.data_ptr(), sg.data_ptr(), ptr(counts_t), ptr(counts_s),
            gc, cap_t, cap_s, scal.data_ptr(), int(precise), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"p3m_pp kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
