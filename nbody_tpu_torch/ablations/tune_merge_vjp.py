"""The contact search and K1's VJP against another commit of the port, on
the card:

    python -m nbody_tpu_torch.ablations.tune_merge_vjp parent DIR

DIR holds the other commit's package (``git archive <commit>
nbody_tpu_torch | tar -x -C DIR``). Each side runs in a process of its own
through its package's public wrappers (``_side.py``), and the sides take
turns (old, new, new, old) on the two-galaxy worlds (seed 11037). Bits:
the contact search's winners at N=65536 after 10 substeps and at N=1M
(equal, or the line says DIFFERENT: the search is exact), and K1's VJP's
four cotangents at N=65536 and at the P3M exact-core rows of the N=1M
slice, precise and rsqrt (max|d| / max|old|: the two kernels sum in other
orders). Times (CUDA events, device ms, best of three): each of those
calls, the merging World substep at N=65536, and the "cuda" rollout's
forward and backward at N=65536 a step.

It prints its lines and writes them as JSON to ``build/tune_merge_vjp/``.
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
OUT = ROOT / "build" / "tune_merge_vjp"
JOBS = [
    ("contact search N=65536 after 10 substeps",
     {"what": "contacts", "n": 65536, "substeps": 10, "reps": 20}),
    ("contact search N=1M", {"what": "contacts", "n": 1 << 20, "reps": 5}),
    ("K1 VJP N=65536 precise",
     {"what": "vjp", "n": 65536, "precise": True, "reps": 5}),
    ("K1 VJP N=65536 rsqrt", {"what": "vjp", "n": 65536, "reps": 5}),
    ("K1 VJP exact-core rows of the N=1M slice, rsqrt",
     {"what": "vjp", "n": 1 << 20, "core": True, "reps": 10}),
    ("K1 VJP exact-core rows of the N=1M slice, precise",
     {"what": "vjp", "n": 1 << 20, "core": True, "precise": True,
      "reps": 10}),
    ("merging World substep N=65536",
     {"what": "merging", "n": 65536, "substeps": 10}),
    ("'cuda' rollout N=65536, forward and backward a step",
     {"what": "rollout", "n": 65536, "steps": 10, "repeats": 2}),
]


def parent(other: Path, log=print) -> list:
    log(f"parent on {_card()}: this tree against {other}")
    times = {"old": [], "new": []}
    for turn, who in enumerate(("old", "new", "new", "old")):
        res = _side_run(other if who == "old" else ROOT,
                        [job for _, job in JOBS], OUT / "parent" / f"{turn}")
        times[who].append(res)
    rows = []
    for i, (label, job) in enumerate(JOBS):
        o, n = ([r[i]["ms"] for r in times[who]] for who in ("old", "new"))
        row = {"what": label, "old": o, "new": n, "ratio": sum(n) / sum(o)}
        line = (f"  {label}: old {o[0]:.4f}, {o[1]:.4f}; new {n[0]:.4f}, "
                f"{n[1]:.4f} ms; new/old {row['ratio']:.4f}")
        path = [OUT / "parent" / t / f"{i}.pt" for t in ("0", "1")]
        if path[0].exists():
            old, new = (torch.load(q) for q in path)
            if job["what"] == "contacts":
                row["equal"] = all(torch.equal(a, b) for a, b in zip(old, new))
                line += (f"; winners {'equal' if row['equal'] else 'DIFFERENT'}"
                         f", {int(old[0].sum())} losers")
            else:
                row["rel"] = [float((a - b).abs().max() / b.abs().max())
                              if b.abs().max() > 0 else float(a.abs().max())
                              for a, b in zip(new, old)]
                line += "; max|d|/max|old| " + ", ".join(
                    f"{x:.2e}" for x in row["rel"])
        log(line)
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> None:
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] != "parent":
        raise SystemExit(__doc__)
    rows = parent(Path(argv[1]).resolve())
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "parent.json").write_text(json.dumps(rows, indent=1))
    if any(row.get("equal") is False for row in rows):
        raise SystemExit("tune_merge_vjp: the contact search's winners differ "
                         "from the other commit's")


if __name__ == "__main__":
    main()
