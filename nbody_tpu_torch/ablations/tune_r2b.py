"""K5b on the card: the script's eight micro-variants of the resident-source
kernel, each against its plain version and as a 50-substep Euler loop.

Counterpart of ``scripts/ablations/tune_r2b.py``, whose ``make_v2`` ran
K5a's kernel with targets as columns (``kernel_cols``: flavors base,
partial, static, and ``unroll=2``) or as a (3, tile) row block
(``kernel_rows``). Here each is a variant of ``csrc/flavor_forces.cu``
(:mod:`..ops.flavor_forces` maps the flavors): the column layout takes
(T, 2) positions and a (T,) radius, the row layout (3, T) rows; the
script's tile_t is P targets per thread times a block of up to 512
threads (tile 1024 is P = 2). Each configuration also runs as the
script's loop: 50 substeps of force, the ``valid`` mask and Euler, the
sources rebuilt from the new positions each substep, beside
``World.update``.

    python -m nbody_tpu_torch.ablations.tune_r2b [N]
"""

from __future__ import annotations

import sys

import torch

from ..ops import flavor_forces as ff
from ..ops.flavor_forces import (as_acc, flavor_acc, flavor_acc_plain,
                                 plain_key, shape)
from ..world import create_world
from . import _scene
from .tune_r2 import DT, SUBSTEPS, time_substeps

# (script's name, flavor, rows, tile_t, chunk): tune_r2b.py:206-213
SWEEP = (
    ("v2_base(512x2048)", "base", False, 512, 2048),
    ("v2_rows(512x2048)", "rows", True, 512, 2048),
    ("v2_partial(512x2048)", "partial", False, 512, 2048),
    ("v2_unroll2(512x2048)", "unroll2", False, 512, 2048),
    ("v2_static(512x2048)", "static", False, 512, 2048),
    ("v2_rows(512x1024)u2", "unroll2", True, 512, 1024),
    ("v2_rows(1024x1024)", "rows", True, 1024, 1024),
    ("v2_rows(256x2048)", "rows", True, 256, 2048),
)


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Every configuration of SWEEP against its plain version (once per
    distinct plain function), twice for bit-equality, timed force-only and
    as the loop; each result counts the kernel launches it made."""
    n, s128 = scene.n, scene.s128
    src = scene.src3(s128)
    valid = torch.ones((n, 1), dtype=torch.float32, device=scene.pos.device)
    world = create_world(scene.particles, device=scene.pos.device)
    world_ms = _scene.time_it(lambda: world.update(DT, SUBSTEPS), reps=1) / SUBSTEPS
    log(f"  World.update (fused kernel, euler): {world_ms * 1e3:.1f} µs/substep "
        f"over {SUBSTEPS} substeps")
    plains, results = {}, []
    for name, flavor, rows, tile_t, chunk in SWEEP:
        p, block = shape(tile_t)

        def targets(pos, rows=rows):
            if not rows:
                return pos, scene.radius
            return torch.stack([pos[:, 0], pos[:, 1], scene.radius])

        def acc(pos=scene.pos, s=src, flavor=flavor, p=p, block=block,
                chunk=chunk, targets=targets):
            return flavor_acc(targets(pos), s, flavor=flavor, p=p,
                              block=block, chunk=chunk)

        def step(state, acc=acc):
            pos, vel = state
            a = as_acc(acc(pos, scene.src3(s128, pos))) * valid
            vel = vel + DT * a
            return pos + DT * vel, vel

        key = plain_key(flavor, p, chunk)
        if key not in plains:
            plains[key] = as_acc(flavor_acc_plain(targets(scene.pos), src,
                                                  flavor=flavor, p=p,
                                                  chunk=chunk))
        before = ff.LAUNCHES
        r = _scene.measure(f"{name} p{p}x{block}", acc, as_acc, plains[key],
                           scene, k1_ms, log)
        r["config"] = {"flavor": flavor, "rows": rows, "tile_t": tile_t,
                       "p": p, "block": block, "chunk": chunk}
        r["substep_ms"] = time_substeps(step, (scene.pos, scene.world.state.vel))
        r["world_ms"] = world_ms
        r["launches"] = ff.LAUNCHES - before
        log(f"  {'':>24}  {SUBSTEPS}-substep loop (force, mask, Euler): "
            f"{r['substep_ms'] * 1e3:.1f} µs/substep, "
            f"{r['substep_ms'] / world_ms:.3f}x World.update")
        results.append(r)
    return _scene.finish("K5b", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5b v2 micro-variants", scene))


if __name__ == "__main__":
    main()
