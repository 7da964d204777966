"""K5h on the card: force only with Newton's third law over the massive
prefix, each massive x massive tile pair computed once.

Counterpart of ``scripts/ablations/tune_r2h.py``. The script's tile_t in
(512, 1024, 256) becomes the tile width W in (128, 256, 512), one target
per thread; its source chunk (fchunk) has no counterpart, since the dual
blocks go tile by tile. The script's kernel is right only where the full
massive tiles fill whole chunks; :func:`check_direct` holds this one to
the plain direct sum at a ragged shape too (mass_len not a whole number of
tiles, N not a whole number of tiles).

    python -m nbody_tpu_torch.ablations.tune_r2h [N]
"""

from __future__ import annotations

import sys

import torch

from ..ops.newton_forces import newton_acc, newton_acc_plain, newton_pairs
from . import _scene

SWEEP = (128, 256, 512)


def as_acc(out) -> torch.Tensor:
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt4(), scene.src4(scene.s128)
    results = []
    for tile in SWEEP:
        want = as_acc(newton_acc_plain(tgt, src, scene.mass_len, tile=tile))
        # the N x mass_len pairs the force needs; the gm = 0 rows that pad
        # the sources to S128 are not counted
        fwd, dual = newton_pairs(scene.n, scene.mass_len, scene.mass_len, tile)
        r = _scene.measure(f"newton({tile})",
                           lambda tile=tile: newton_acc(
                               tgt, src, mass_len=scene.mass_len, tile=tile),
                           as_acc, want, scene, k1_ms, log)
        r["config"] = {"tile": tile, "forward_pairs": fwd, "dual_pairs": dual}
        log(f"  {'':>24}  {dual} dual pairs, {fwd} forward pairs")
        results.append(r)
    return _scene.finish("K5h", results)


def check_direct(scene: _scene.Scene, log=print) -> list:
    """Every tile width against the plain direct sum of the scene (any N
    and mass_len), twice for bit-equality."""
    tgt, src = scene.tgt4(), scene.src4(scene.s128)
    want = scene.control()
    results = []
    for tile in SWEEP:
        first, again = (as_acc(newton_acc(tgt, src, mass_len=scene.mass_len,
                                          tile=tile)) for _ in range(2))
        same = torch.equal(first, again)
        err = _scene.rel(first, want)
        ok = same and err < _scene.BOUND and bool(torch.isfinite(first).all())
        log(f"  newton({tile}) at N={scene.n} mass_len={scene.mass_len} "
            f"({scene.mass_len % tile} ragged massive rows, {scene.n % tile} "
            f"ragged target rows) against the direct sum: max|d|/max|ref| "
            f"{err:.3e}, bit-equal {same}{'' if ok else '  FAIL'}")
        results.append({"name": f"newton({tile}) N={scene.n}", "err": err,
                        "ok": ok})
    return _scene.finish("K5h against the direct sum", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5h Newton", scene))
    check_direct(scene)


if __name__ == "__main__":
    main()
