"""K5a on the card: force only over chunks of resident sources, swept over
block and chunk, each also timed as a 50-substep Euler loop.

Counterpart of ``scripts/ablations/tune_r2.py`` (the ``v2_resident``
variants). The script swept tile_t in (512, 1024, 2048) targets per grid
step and chunk in (512, 1024, 2048, 4096) sources; here the target tile is
a block of 128, 256 or 512 threads (one target each) and the chunk is the
sources staged through shared memory per pass, 512-4096 (8-64 KB). The
script's v0 and v1 variants were K1 with other source paddings; K1's
``force_acc`` is the line every configuration is compared with, and the
World's fused substep the one the loop is compared with.

    python -m nbody_tpu_torch.ablations.tune_r2 [N]
"""

from __future__ import annotations

import sys

import torch

from ..ops.resident_forces import v2_acc, v2_acc_plain
from ..world import create_world
from . import _scene

BLOCKS = (128, 256, 512)
CHUNKS = (512, 1024, 2048, 4096)
SWEEP = tuple((block, chunk) for block in BLOCKS for chunk in CHUNKS)
SUBSTEPS = 50     # the script's fused substeps per timed call
DT = 0.001


def time_substeps(step, state, iters: int = SUBSTEPS, repeats: int = 3) -> float:
    """Milliseconds per substep of ``iters`` calls of step: state -> state
    from ``state``, best of ``repeats`` after one warm-up loop (the
    script's ``time_substeps``)."""
    def loop():
        s = state
        for _ in range(iters):
            s = step(s)
        return s

    return _scene.time_it(loop, reps=1, repeats=repeats) / iters


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    """Every configuration of SWEEP against the plain version (once per
    scene), twice for bit-equality, timed force-only and as the loop."""
    n, s128 = scene.n, scene.s128
    src = scene.src3(s128)
    want = v2_acc_plain(scene.pos, scene.radius, src)
    valid = torch.ones((n, 1), dtype=torch.float32, device=scene.pos.device)
    world = create_world(scene.particles, device=scene.pos.device)
    world_ms = _scene.time_it(lambda: world.update(DT, SUBSTEPS), reps=1) / SUBSTEPS
    log(f"  World.update (fused kernel, euler): {world_ms * 1e3:.1f} µs/substep "
        f"over {SUBSTEPS} substeps")
    results = []
    for block, chunk in SWEEP:
        def acc(p=scene.pos, s=src, block=block, chunk=chunk):
            return v2_acc(p, scene.radius, s, block=block, chunk=chunk)

        def step(state, acc=acc):
            p, v = state
            a = acc(p, scene.src3(s128, p)) * valid
            v = v + DT * a
            return p + DT * v, v

        r = _scene.measure(f"v2_resident({block}x{chunk})", acc, lambda a: a,
                           want, scene, k1_ms, log)
        r["config"] = {"block": block, "chunk": chunk}
        r["substep_ms"] = time_substeps(step, (scene.pos, scene.world.state.vel))
        r["world_ms"] = world_ms
        log(f"  {'':>24}  {SUBSTEPS}-substep loop (force, mask, Euler): "
            f"{r['substep_ms'] * 1e3:.1f} µs/substep, "
            f"{r['substep_ms'] / world_ms:.3f}x World.update")
        results.append(r)
    return _scene.finish("K5a", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5a v2_resident", scene))


if __name__ == "__main__":
    main()
