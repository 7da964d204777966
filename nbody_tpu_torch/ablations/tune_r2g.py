"""K5g on the card: force only with P targets per thread, each
shared-memory source read serving P pairs.

Counterpart of ``scripts/ablations/tune_r2g.py``. The script's
(P, sub_t, chunk) sweep becomes (P, block, chunk): P targets per thread,
``block`` threads per block, ``chunk`` sources per shared-memory pass.
Each configuration takes the source split of ``force_acc`` when its
target blocks cannot fill the card; one configuration is also run without
it (split 1) to show what that costs.

    python -m nbody_tpu_torch.ablations.tune_r2g [N]
"""

from __future__ import annotations

import sys

import torch

from ..ops.direct_forces import sm_count
from ..ops.ptile_forces import ptile_acc, ptile_acc_plain, split_plan
from . import _scene

# (P, block, chunk, n_split); n_split None is the split plan
SWEEP = (
    (1, 256, 2048, None),
    (2, 256, 2048, None),
    (4, 256, 2048, None),
    (4, 256, 2048, 1),
    (4, 128, 1024, None),
    (8, 128, 2048, None),
    (2, 512, 1024, None),
    (4, 256, 4096, None),
)


def as_acc(out) -> torch.Tensor:
    return torch.stack([out[0][0], out[1][0]], dim=-1)


def run(scene: _scene.Scene, k1_ms: float, log=print) -> list:
    tgt, src = scene.tgt3(), scene.src3(scene.s128)
    want = as_acc(ptile_acc_plain(tgt, src))
    sms = sm_count(scene.pos.device.index or 0)
    results = []
    for p, block, chunk, n_split in SWEEP:
        splits = n_split or split_plan(scene.n, scene.s128, p, block, chunk, sms)
        blocks = -(-scene.n // (p * block))
        r = _scene.measure(f"p{p}x{block}c{chunk} split {splits}",
                           lambda p=p, block=block, chunk=chunk, n=n_split:
                           ptile_acc(tgt, src, p=p, block=block, chunk=chunk,
                                     n_split=n),
                           as_acc, want, scene, k1_ms, log)
        r["config"] = {"p": p, "block": block, "chunk": chunk,
                       "n_split": splits, "blocks": blocks * splits}
        results.append(r)
    return _scene.finish("K5g", results)


def main() -> None:
    _scene.require_cuda()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else _scene.N
    scene = _scene.make_scene(n)
    run(scene, _scene.header("K5g p-tile", scene))


if __name__ == "__main__":
    main()
