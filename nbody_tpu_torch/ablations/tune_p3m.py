"""K4 and the p3m substep against another commit of the port, on the card:

    python -m nbody_tpu_torch.ablations.tune_p3m parent DIR

DIR holds the other commit's package (``git archive <commit>
nbody_tpu_torch | tar -x -C DIR``). Each side runs in a process of its own
through its package's public wrappers (``_side.py``: ``pp_cells`` where a
tree has it, else ``pp_blocks`` on blocks packed from the same bins), and
the sides take turns (old, new, new, old), on the N=1M two-galaxy world
(seed 11037) with the slice's p3m config (grid 2048, cell capacity 768).
Bits: each target's correction in cell order, rsqrt and precise, this
tree's against the other's. Times: the K4 call that a substep makes, and
the p3m substep (CUDA events, device ms).

It prints its lines and writes them as JSON to ``build/tune_p3m/``.
Without a CUDA device it raises.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from ._scene import require_cuda
from .tune_direct import _card, _side_run

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "tune_p3m"
SLICE = {"n": 1 << 20, "grid": 2048, "cap": 768}
BIT_JOBS = [{"what": "pp", **SLICE, "precise": precise}
            for precise in (False, True)]
TIMED_JOBS = [{"what": "pp", **SLICE, "reps": 20},
              {"what": "p3m", **SLICE, "substeps": 10}]
TIMED_LABELS = ["K4 ms (N=1M slice)", "p3m ms/substep (N=1M slice)"]


def parent(other: Path, log=print) -> list:
    log(f"parent on {_card()}: this tree against {other}")
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        jobs = BIT_JOBS if turn < 2 else []
        res = _side_run(other if who == "old" else ROOT, jobs + TIMED_JOBS,
                        OUT / "parent" / f"{turn}")
        times[who].append(res[len(jobs):])
    rows = []
    for i, job in enumerate(BIT_JOBS):
        (want,), (got,) = (torch.load(OUT / "parent" / t / f"{i}.pt")
                           for t in ("0", "1"))
        tag = "precise" if job["precise"] else "rsqrt"
        eq = torch.equal(got, want)
        diff = int((got != want).any(1).sum())
        log(f"  bits, K4 rows at the N=1M slice, {tag}: "
            f"{'equal' if eq else 'DIFFERENT'} ({diff} of {len(got)} rows "
            f"differ, max|d| {float((got - want).abs().max()):.3e})")
        rows.append({"what": f"bits {tag}", "equal": eq, "rows_differ": diff})
    for k, label in enumerate(TIMED_LABELS):
        o, n = ([r[k]["ms"] for r in times[who]] for who in ("old", "new"))
        ratio = sum(n) / sum(o)
        log(f"  {label}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, "
            f"{n[1]:.4f}; new/old {ratio:.4f}")
        rows.append({"what": label, "old": o, "new": n, "ratio": ratio})
    return rows


def main(argv: list[str] | None = None) -> None:
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] != "parent":
        raise SystemExit(__doc__)
    rows = parent(Path(argv[1]).resolve())
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "parent.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
