"""K5d on the card: source-stationary force, one source chunk per block in
shared memory, per-chunk partials summed in chunk order.

Counterpart of ``scripts/ablations/tune_r2d.py``. The script's
(tile_t, chunk) list becomes (block, chunk): ``block`` targets per tile
walked by a block, ``chunk`` sources resident in its shared memory. Blocks
walk slabs of the target tiles so that few chunks still fill the card;
one configuration also runs the pure form (one slab: every block walks
every tile). The script's ``manual_reduce`` has no counterpart (a thread
sums serially), so its one manual configuration is not repeated.

    python -m nbody_tpu_torch.ablations.tune_r2d [N]
"""

from __future__ import annotations

import sys

from ..ops.direct_forces import sm_count
from ..ops.stationary_forces import slab_plan, stationary_acc, stationary_acc_plain
from ..types import round_up
from . import _scene

# (block, chunk, slabs); slabs None is the slab plan
SWEEP = (
    (256, 128, None),
    (256, 256, None),
    (256, 256, 1),
    (256, 512, None),
    (256, 1024, None),
    (256, 2048, None),
    (512, 512, None),
    (512, 1024, None),
    (1024, 512, None),
    (128, 512, None),
)


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt = scene.tgt3()
    sms = sm_count(scene.pos.device.index or 0)
    results = []
    for block, chunk, slabs in SWEEP:
        s_pad = round_up(scene.mass_len, chunk)
        src = scene.src3(s_pad)
        want = stationary_acc_plain(tgt, src, chunk=chunk).T
        n_slabs = slabs or slab_plan(scene.n, s_pad, block, chunk, sms)
        r = _scene.measure(f"k3({block}x{chunk}) slabs {n_slabs}",
                           lambda block=block, chunk=chunk, slabs=slabs, src=src:
                           stationary_acc(tgt, src, block=block, chunk=chunk,
                                          slabs=slabs),
                           lambda a: a.T,
                           want, scene, k1_ms, log)
        r["config"] = {"block": block, "chunk": chunk, "slabs": n_slabs,
                       "s_pad": s_pad, "blocks": (s_pad // chunk) * n_slabs,
                       "partial_mb": (s_pad // chunk) * scene.n * 8 / 1e6}
        log(f"  {'':>24}  dead source rows {s_pad - scene.mass_len}, "
            f"{r['config']['blocks']} blocks, partials "
            f"{r['config']['partial_mb']:.1f} MB")
        results.append(r)
    return _scene.finish("K5d", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5d source-stationary", scene))


if __name__ == "__main__":
    main()
