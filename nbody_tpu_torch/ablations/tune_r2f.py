"""K5f on the card: the marginal cost of one elementwise expression, for the
nine expressions of the script, beside the SASS of its loop.

Counterpart of ``scripts/ablations/tune_r2f.py``, which timed a Pallas
kernel chaining ``a = expr(a, y)`` over a (256, 2048) block at LO = 4096
and HI = 12288 loops and took the difference as the cost of 8192
iterations. Here the kernel is ``csrc/op_probe.cu`` (one thread per
element, :mod:`..ops.op_probe`): each launch at LO and at HI is timed with
CUDA events after a warm-up, and the marginal time gives the nanoseconds
per element-iteration and the issue cycles per warp per iteration (time x
SM clock x 4 schedulers x SMs / (elements / 32 x 8192)), beside the SASS
instructions of the loop's pass of 8 iterations, divided by 8 (the loop's
3 instructions of bookkeeping included; for ``sqrt`` the count includes
its slow path, laid out inside the loop and jumped over). Inputs: x
uniform in [1, 2), y uniform in [1e-7, 2e-7) for ``add`` and in [1e-7, 2)
otherwise (tune_r2f.py:54, :69-70), drawn with numpy from a seed.

    python -m nbody_tpu_torch.ablations.tune_r2f
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _build, sass
from ..ops.op_probe import EXPRS, op_probe, op_probe_plain
from . import _scene

TT, CC = 256, 2048
LO, HI = 4096, 12288
SEED = 0
PASS = 8          # csrc/op_probe.cu kPass: expressions per pass of the loop
# (fp32 operations, MUFU operations) an iteration, an FFMA counting two
OPS = {"add": (1, 0), "mul": (1, 0), "fma_pat": (2, 0), "rsqrt": (1, 1),
       "sqrt": (1, 1), "recip_apx": (1, 1), "rsqrt3": (3, 1),
       "full_f": (4, 1), "sq_chain": (5, 0)}
# Kernel against the plain chain at LO loops, max|d|/max|ref| over the
# finite entries (sq_chain overflows to inf where y > ~1.51, on both
# sides). add and mul are one IEEE operation on both sides: bit-equal.
# rsqrt, sqrt and recip_apx are contracting maps whose fixed points the
# two sides reach alike (measured bit-equal on an H100); a few ulp allow
# for MUFU. fma_pat: the kernel's FFMA rounds once where PyTorch rounds
# twice, and a map that shrinks by only 0.9999 a step keeps the
# differences: up to LO x 2^-23 = 4.9e-4 (measured 9.97e-5). full_f: b·i³
# + 0.5 is one FFMA, and the map's slope nears -1 where y nears 2, so
# ulps are not damped. sq_chain: a·a + b·b is an FFMA, and where y nears
# ~1.51 the map's two fixed points merge and it converges slowly. Their
# bounds are about 5x and 7x the readings they were set from: full_f
# 4.155e-4 on these inputs (7.2e-5 on another draw), sq_chain 2.875e-5
# (5.2e-6 on another draw); the margin covers the data-dependent size of
# these undamped ulps on other inputs, such as the card tests' (64, 300)
# slice at 4099 loops. rsqrt3 measured 3.9e-7. (H100 80GB HBM3, 700 W,
# this module.)
BOUNDS = {"add": 0.0, "mul": 0.0, "fma_pat": 5e-4, "rsqrt": 1e-6,
          "sqrt": 1e-6, "recip_apx": 1e-6, "rsqrt3": 5e-6, "full_f": 2e-3,
          "sq_chain": 2e-4}


def inputs(expr: str, device, seed: int = SEED):
    """(x, y), each (TT, CC) fp32, for one expression."""
    x = np.random.RandomState(seed).uniform(1.0, 2.0, (TT, CC))
    hi = 2e-7 if expr == "add" else 2.0
    y = np.random.RandomState(seed + 1).uniform(1e-7, hi, (TT, CC))
    return (torch.from_numpy(a.astype(np.float32)).to(device) for a in (x, y))


def loop_length(expr: str, funcs: dict | None = None) -> int:
    """SASS instructions in the expression's pass of PASS iterations."""
    if funcs is None:
        funcs = sass.functions(_build.library_path("op_probe"))
    name = sass.find(funcs, rf"probe_kernelILi{EXPRS.index(expr)}EE")
    return sass.pair_loop(funcs[name])[0]


def run(device, log=print) -> list:
    """Each expression: checked at LO against its plain chain and twice for
    bit-equality, timed at LO and HI."""
    clock = _scene.sm_clock_mhz()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    funcs = sass.functions(_build.library_path("op_probe"))
    n = TT * CC
    iters = HI - LO
    log(f"  {n} elements, marginal over {iters} iterations; {sms} SMs at "
        f"{clock:g} MHz")
    results = []
    for expr in EXPRS:
        x, y = inputs(expr, device)
        first, again = (op_probe(x, y, expr=expr, loops=LO) for _ in range(2))
        want = op_probe_plain(x, y, expr=expr, loops=LO)
        torch.cuda.synchronize()
        same = _scene.bit_equal(first, again)
        err, same_nonfinite = _scene.rel_finite(first, want)
        bound = BOUNDS[expr]
        close = _scene.bit_equal(first, want) if bound == 0 else err < bound
        ms_lo, ms_hi = (_scene.time_it(lambda loops=loops: op_probe(
            x, y, expr=expr, loops=loops), reps=5) for loops in (LO, HI))
        marginal = ms_hi - ms_lo
        ns = marginal * 1e6 / (n * iters)
        cycles = marginal * 1e-3 * clock * 1e6 * 4 * sms / (n / 32 * iters)
        per_iter = loop_length(expr, funcs) / PASS
        ok = same and close and same_nonfinite
        log(f"  {expr:>10}: {marginal:.4f} ms marginal ({ms_lo:.4f} at {LO}, "
            f"{ms_hi:.4f} at {HI}), {ns * 1e3:.4f} ps/element-iteration, "
            f"{n * iters / (marginal * 1e-3):.4e} element-iterations/s, "
            f"{cycles:.2f} issue cycles/warp-iteration, SASS {per_iter:.3f} "
            f"a iteration; max|d|/max|ref| {err:.3e} (bound {bound:g}), "
            f"non-finite {int((~torch.isfinite(want)).sum())}, bit-equal "
            f"{same}{'' if ok else '  FAIL'}")
        diff = (first - want)[torch.isfinite(want)].abs()
        results.append({"name": expr, "ms": marginal, "ms_lo": ms_lo,
                        "ms_hi": ms_hi, "ns": ns, "cycles": cycles,
                        "sass_per_iter": per_iter, "err": err, "ok": ok,
                        "max_abs_err": float(diff.max()) if diff.numel() else 0.0})
    return _scene.finish("K5f", results)


def main() -> None:
    device = _scene.require_cuda()
    print("K5f op-cost probes")
    run(device)


if __name__ == "__main__":
    main()
