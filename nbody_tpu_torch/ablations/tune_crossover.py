"""The direct-sum against P³M crossover that backend="auto" encodes
(``world.AUTO_P3M_MIN_PAIRS``), measured on the card:

    python -m nbody_tpu_torch.ablations.tune_crossover [N ...]

The counterpart of ``scripts/ablations/tune_r3h_crossover.py``: for each N
of the ladder (65536, 131072, 196608, 262144 and 393216 unless given), two
galaxies of seed 1 at the default config, ``World.update(0.005, 32)`` on
"cuda" (the direct kernel) and on "p3m", after a warm-up of 2 substeps,
best of two. The time is the host clock around the update and a
synchronize, the wall time a user waits (the p3m substep is host-bound at
small N), with the device time from CUDA events beside it. One line a
rung, then the crossover: the pair count N · mass_len of the largest rung
at which "cuda" is still at least as fast, and of the first rung above it
at which "p3m" wins. If "cuda" wins the whole default ladder, the ladder
goes on to N=1048576. Writes its rows as JSON to
``build/tune_crossover/ladder.json``. Without a CUDA device it raises.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from ._scene import require_cuda
from .tune_direct import _card

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_crossover"
LADDER = (65_536, 131_072, 196_608, 262_144, 393_216)
EXTENSION = (524_288, 786_432, 1_048_576)
DT, STEPS, REPS, SEED = 0.005, 32, 2, 1
BACKENDS = ("cuda", "p3m")


def measure(n: int, device, log=print) -> dict:
    """One rung: the best wall and device ms a substep of each backend."""
    import nbody_tpu_torch as nt

    scene = nt.make_galaxies(n, 2, seed=SEED)
    row = {"n": n}
    for backend in BACKENDS:
        w = nt.create_world(scene, device=device, default_backend=backend)
        row["mass_len"] = w.mass_len
        w.update(DT, 2)
        w.block_until_ready()
        wall = dev = float("inf")
        for _ in range(REPS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            w.update(DT, STEPS)
            end.record()
            torch.cuda.synchronize()
            wall = min(wall, (time.perf_counter() - t0) * 1e3 / STEPS)
            dev = min(dev, start.elapsed_time(end) / STEPS)
        row[backend], row[f"{backend}_device"] = wall, dev
        del w
    row["pairs"] = n * row["mass_len"]
    row["pick"] = "cuda" if row["cuda"] <= row["p3m"] else "p3m"
    log(f"  N={n:8d} pairs={row['pairs']:.4e}: cuda {row['cuda']:9.4f} ms "
        f"(device {row['cuda_device']:9.4f}), p3m {row['p3m']:9.4f} ms "
        f"(device {row['p3m_device']:9.4f}) -> {row['pick']}")
    return row


def crossover(rows: list) -> dict:
    """The largest rung's pairs at which "cuda" is at least as fast as
    "p3m" (None if it never is), and the first larger rung's at which
    "p3m" wins (None past the ladder)."""
    rows = sorted(rows, key=lambda r: r["pairs"])
    direct = [r for r in rows if r["pick"] == "cuda"]
    last = direct[-1]["pairs"] if direct else None
    above = [r for r in rows if r["pick"] == "p3m"
             and (last is None or r["pairs"] > last)]
    return {"direct_up_to": last,
            "p3m_from": above[0]["pairs"] if above else None}


def main(argv: list[str] | None = None, log=print) -> dict:
    device = require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    ns = [int(a) for a in argv] or list(LADDER)
    log(f"crossover on {_card()}: 'cuda' against 'p3m', default config, two "
        f"galaxies, seed {SEED}, {STEPS} substeps of {DT}, best of {REPS}")
    rows = [measure(n, device, log) for n in ns]
    if not argv and all(r["pick"] == "cuda" for r in rows):
        log("  'cuda' wins the whole ladder: extended to N=1048576")
        rows += [measure(n, device, log) for n in EXTENSION]
    out = {"card": _card(), "rows": rows, **crossover(rows)}
    log(f"  crossover: 'cuda' at least as fast up to {out['direct_up_to']} "
        f"pairs, 'p3m' faster from {out['p3m_from']}")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ladder.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
