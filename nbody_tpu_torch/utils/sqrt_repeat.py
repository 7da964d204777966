"""Repeatability of the port's plain versions on the CPU across fresh
processes: every call in every process must give the same bits.

    python -m nbody_tpu_torch.utils.sqrt_repeat [--processes 48]
        [--threads 8] [--torch-sqrt] [--first direct|pp|op_probe]

Starts ``--processes`` fresh Python processes, one after another, each with
``--threads`` intra-op threads. Each calls three times, and hashes, the
plain versions whose results depend on a square root:

  * ``forces.direct_sum_acc(precise=True)`` on the N=4096 two-galaxy scene
    (seed 11037);
  * ``p3m_pp.pp_cells`` (its plain version, rsqrt and precise) on the cells
    of the N=2048 two-galaxy scene at grid 256, cap 8;
  * ``op_probe.op_probe`` of the ``sqrt`` expression, 3 loops, on
    ``tune_r2f``'s (256, 2048) inputs;

and ``forces.sqrt`` of 8e6 fp32 elements; and counts the elements of a
1e6-element fp32 array on which ``forces.sqrt`` differs from
``np.sqrt``. ``--torch-sqrt`` puts
``torch.sqrt`` in place of ``forces.sqrt`` to show what it replaced; each
process computes the quantities in the order above, or ``--first`` first
(a process's first large sqrt is the one that may drift); for the 8e6
element sqrt it also reports which elements its first call got
differently from a later one, and its max relative error.
Prints each quantity's distinct hashes with their counts, then one JSON
line; exits 1 if any quantity took more than one value (or sqrt differed
from numpy) without ``--torch-sqrt``.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

CALLS = 3
FIRST = {"direct": "direct_sum_acc precise N=4096",
         "pp": "pp_cells precise=False N=2048 cap 8",
         "op_probe": "op_probe sqrt 3 loops",
         "block": "sqrt of 8e6 elements"}
BLOCK = "first 8e6-element sqrt against a later one"


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()[:12]


def _big_input() -> np.ndarray:
    return np.random.default_rng(1).uniform(0.5, 2e6, 8_000_000).astype(
        np.float32)


def _jobs() -> dict:
    """{quantity: () -> tensor}, each one of the plain versions above."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch import forces
    from nbody_tpu_torch.ablations import tune_r2f
    from nbody_tpu_torch.ops import op_probe, p3m_forces, p3m_pp

    w = nt.create_world(nt.make_galaxies(4096, 2, seed=11037), device="cpu")
    st = w.state
    small = nt.create_world(nt.make_galaxies(2048, 2, seed=11037),
                            device="cpu")
    pos, rad = small.state.pos, small.state.radius
    src, gm = pos[:small.mass_len], small.gm
    bins = p3m_forces.p3m_bins(pos, rad, src, gm, grid=256, rc_cells=4,
                               exact_targets=0)
    trows = p3m_forces._cell_rows(pos, rad + nt.types.SOFTENING_FLOOR,
                                  bins["order_t"])
    srows = p3m_forces._cell_rows(src, gm, bins["order_s"])
    x, y = tune_r2f.inputs("sqrt", "cpu")
    big = torch.from_numpy(_big_input())

    def pp(precise):
        return lambda: p3m_pp.pp_cells(
            trows, srows, bins["start_t"], bins["counts_t"], bins["start_s"],
            bins["counts_s"], 4 * bins["h"], 4.0, cap_t=8, cap_s=8,
            precise=precise)

    return {
        "direct_sum_acc precise N=4096": lambda: forces.direct_sum_acc(
            st.pos, st.radius, st.pos[:w.mass_len], w.gm, precise=True),
        "pp_cells precise=False N=2048 cap 8": pp(False),
        "pp_cells precise=True N=2048 cap 8": pp(True),
        "op_probe sqrt 3 loops": lambda: op_probe.op_probe(
            x, y, expr="sqrt", loops=3),
        "sqrt of 8e6 elements": lambda: forces.sqrt(big),
    }


def _block(a: torch.Tensor, b: torch.Tensor, want: np.ndarray) -> list:
    """[elements where a and b differ, the first and the last of them, the
    max relative error of a against want]."""
    bad = torch.nonzero(a != b).reshape(-1)
    rel = np.abs(a.numpy().astype(np.float64) - want) / want
    return [int(bad.numel()), int(bad[0]) if bad.numel() else -1,
            int(bad[-1]) if bad.numel() else -1, float(rel.max())]


def child(threads: int, torch_sqrt: bool, first: str | None) -> dict:
    torch.set_num_threads(threads)
    from nbody_tpu_torch import forces

    if torch_sqrt:
        forces.sqrt = torch.sqrt
    jobs = _jobs()
    if first is not None:
        jobs = {first: jobs[first],
                **{k: v for k, v in jobs.items() if k != first}}
    out = {key: [] for key in jobs}
    firsts = {}
    for _ in range(CALLS):
        for key, job in jobs.items():
            res = job()
            firsts.setdefault(key, res)
            out[key].append(_hash(res))
    key = FIRST["block"]
    out[BLOCK] = _block(firsts[key], jobs[key](),
                        np.sqrt(_big_input().astype(np.float64)))
    v = np.random.default_rng(0).uniform(0.5, 2e6, 1_000_000).astype(np.float32)
    out["sqrt != np.sqrt (elements)"] = [
        int((forces.sqrt(torch.from_numpy(v)).numpy() != np.sqrt(v)).sum())]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=48)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--torch-sqrt", action="store_true")
    ap.add_argument("--first", choices=FIRST, default=None,
                    help="the quantity each process computes first")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    first = None if args.first is None else FIRST[args.first]
    if args.child:
        print(json.dumps(child(args.threads, args.torch_sqrt, first)))
        return 0
    cmd = [sys.executable, "-m", "nbody_tpu_torch.utils.sqrt_repeat",
           "--child", "--threads", str(args.threads)]
    if args.torch_sqrt:
        cmd.append("--torch-sqrt")
    if args.first:
        cmd += ["--first", args.first]
    seen = collections.defaultdict(collections.Counter)
    first_moved = collections.Counter()
    blocks = []
    for _ in range(args.processes):
        res = json.loads(subprocess.run(cmd, capture_output=True, text=True,
                                        check=True).stdout.splitlines()[-1])
        blocks.append(res.pop(BLOCK))
        for key, values in res.items():
            seen[key].update(str(v) for v in values)
            if len(set(values)) > 1:
                first_moved[key] += 1
    moved = [b for b in blocks if b[0]]
    summary = {"processes": args.processes, "threads": args.threads,
               "sqrt": "torch.sqrt" if args.torch_sqrt else "forces.sqrt",
               "first": first, "results": {},
               "block": {"processes_moved": len(moved),
                         "moved": [b[:3] for b in moved],
                         "max_rel_err": max(b[3] for b in blocks)}}
    ok = not moved
    for key, counter in seen.items():
        print(f"{key}: {dict(counter)}; processes whose calls differed: "
              f"{first_moved[key]}")
        summary["results"][key] = {"distinct": len(counter),
                                   "processes_moved": first_moved[key]}
        bad = (set(counter) != {"0"} if key.startswith("sqrt !=")
               else len(counter) > 1)
        ok = ok and not bad
    print(f"{BLOCK}: differed in {len(moved)} processes, (elements, first, "
          f"last) {[b[:3] for b in moved]}; max relative error of a first "
          f"call {summary['block']['max_rel_err']:.3e}")
    print(json.dumps(summary))
    return 0 if ok or args.torch_sqrt else 1


if __name__ == "__main__":
    sys.exit(main())
