"""Per-instruction cost probes (K5f): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``make_probe(expr, loops)`` in
``scripts/ablations/tune_r2f.py``, whose Pallas kernel chains ``a =
expr(a, y)`` ``loops`` times over a (256, 2048) block; the kernel is
``csrc/op_probe.cu``, one thread per element. The nine expressions are
the script's (``EXPRS``, in its order). The plain version runs the same
chain as PyTorch ops, each rounded to fp32: it differs from the kernel
where nvcc contracts a multiply and an add into one FFMA (one rounding
instead of two), where MUFU.RSQ's approximation differs from PyTorch's
rsqrt, and in ``recip_apx``, which the kernel computes with PTX's
``rcp.approx.ftz.f32`` and the plain version as ``1 / a``. CPU tensors
take the plain version; CUDA tensors launch the kernel, and anything wrong
there raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .direct_forces import _check, _device_of, _raise_on

EXPRS = ("add", "mul", "fma_pat", "rsqrt", "sqrt", "recip_apx", "rsqrt3",
         "full_f", "sq_chain")

# Kernel launches made by the wrapper in this process (plain-version calls
# are not counted).
LAUNCHES = 0


def _f32(v: float) -> float:
    """v rounded to fp32, as the script's weakly typed constants are."""
    return float(np.float32(v))


_C = {v: _f32(v) for v in (1.0000001, 0.9999, 1e-4, 0.5, 0.1, 0.3)}


def expr_plain(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One application of the named expression (tune_r2f.py:55-65)."""
    c = _C
    if name == "add":
        return a + b
    if name == "mul":
        return a * c[1.0000001]
    if name == "fma_pat":
        return a * c[0.9999] + c[1e-4]
    if name == "rsqrt":
        return torch.rsqrt(a) + c[0.5]
    if name == "sqrt":
        return torch.sqrt(a) + c[0.1]
    if name == "recip_apx":
        return torch.reciprocal(a) + c[0.5]
    if name == "rsqrt3":
        i = torch.rsqrt(a)
        return i * i * i + c[0.5]
    if name == "full_f":
        i = torch.rsqrt(a)
        return b * (i * i * i) + c[0.5]
    if name == "sq_chain":
        return (a * a + b * b + c[0.5]) * c[0.3]
    raise ValueError(f"expr must be one of {EXPRS}, got {name!r}")


def op_probe_plain(x: torch.Tensor, y: torch.Tensor, *, expr: str,
                   loops: int) -> torch.Tensor:
    """Plain version of :func:`op_probe`."""
    a = x
    for _ in range(loops):
        a = expr_plain(expr, a, y)
    return a.clone() if loops == 0 else a


def _lib():
    from . import _build

    return _build.load("op_probe")


def op_probe(x: torch.Tensor, y: torch.Tensor, *, expr: str,
             loops: int) -> torch.Tensor:
    """``expr`` applied ``loops`` times to x elementwise, with y as its
    second operand; x and y fp32 of one shape."""
    device = _device_of(x)
    _check("x", x, tuple(x.shape), device)
    _check("y", y, tuple(x.shape), device)
    if expr not in EXPRS:
        raise ValueError(f"expr must be one of {EXPRS}, got {expr!r}")
    if not 0 <= loops < 2**31:
        raise ValueError(f"loops must be in [0, 2**31), got {loops}")
    if x.numel() >= 2**31:
        raise ValueError(f"at most 2**31 - 1 elements, got {x.numel()}")
    if device.type == "cpu":
        return op_probe_plain(x, y, expr=expr, loops=loops)
    global LAUNCHES
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        err = _lib().nbody_op_probe(
            x.data_ptr(), y.data_ptr(), x.numel(), EXPRS.index(expr), loops,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on(err, f"op_probe ({expr})")
    LAUNCHES += 1
    return out
