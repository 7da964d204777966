"""K5e on the card: the reductions of the row-layout kernel, each against
its plain version.

Counterpart of ``scripts/ablations/tune_r2e.py``, whose ``make_v3`` ran
K5b's row kernel with four reductions: ``control`` (a per-chunk sum),
``partial_jnp`` (a (tile, 128) lane-partial carry), ``fma_kloop`` (128-wide
FMAs into that carry) and ``f_assoc`` (f = (gm·inv)·(inv·inv)). Here each
is a variant of ``csrc/flavor_forces.cu`` (:mod:`..ops.flavor_forces`):
the lanes become K chains a target (8 at P <= 2, 4 at P = 4, 2 at P = 8),
and the script's tile_t of 1024-4096 targets is P = 2-8 targets per thread
in blocks of 512, its chunk the sources staged per pass.

    python -m nbody_tpu_torch.ablations.tune_r2e [N]
"""

from __future__ import annotations

import sys

from ..ops.flavor_forces import (as_acc, flavor_acc, flavor_acc_plain,
                                 plain_key, shape)
from . import _scene

# (flavor, tile_t, chunk): tune_r2e.py:148-156
SWEEP = (
    ("fma_kloop", 1024, 2048),
    ("fma_kloop", 2048, 2048),
    ("fma_kloop", 2048, 1024),
    ("fma_kloop", 4096, 1024),
    ("fma_kloop", 1024, 4096),
    ("control", 1024, 2048),
    ("f_assoc", 1024, 2048),
)


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    plains, results = {}, []
    for flavor, tile_t, chunk in SWEEP:
        p, block = shape(tile_t)
        key = plain_key(flavor, p, chunk)
        if key not in plains:
            plains[key] = as_acc(flavor_acc_plain(tgt, src, flavor=flavor,
                                                  p=p, chunk=chunk))
        r = _scene.measure(
            f"{flavor}({tile_t}x{chunk}) p{p}",
            lambda flavor=flavor, p=p, block=block, chunk=chunk: flavor_acc(
                tgt, src, flavor=flavor, p=p, block=block, chunk=chunk),
            as_acc, plains[key], scene, k1_ms, log)
        r["config"] = {"flavor": flavor, "tile_t": tile_t, "p": p,
                       "block": block, "chunk": chunk}
        results.append(r)
    return _scene.finish("K5e", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5e v3 reductions", scene))


if __name__ == "__main__":
    main()
