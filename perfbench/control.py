"""Readings that a cell's limits are set from, in one process on the card:

    python3 perfbench/control.py --workload <name> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--out FILE]

For each seed of ``--seeds``, a run of the cell with a window of
``--seconds`` and the numbers the judge compares for the program: their
largest over the seeds is each number's lower reading. For each seed of
``--control-seeds``, the same numbers for the control, the reference put in
the program's place at the same judged substeps and computed in bfloat16:
their smallest is each number's upper reading. Prints one JSON line a seed
and a summary last; with ``--out`` writes them there too. The benchmark's
own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from perfbench.run import CACHES

    for key, path in CACHES.items():
        os.environ[key] = str(path)
    import torch

    from perfbench import harness, judge

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    lines = []
    lower: dict = {}
    upper: dict = {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        sc, snaps, _ = harness.simulate(cell, seed, args.seconds, False, "cuda",
                                        time.perf_counter())
        if seed in args.seeds:
            got = cell.numbers()(cell.config, sc, snaps, seed, "cuda")
            lines.append({"seed": seed, "side": "program", "numbers": got})
            lower = {k: max(lower.get(k, v), v) for k, v in got.items()}
        if seed in args.control_seeds:
            got = cell.numbers()(cell.config, sc, snaps, seed, "cuda",
                                 post=judge.control_post(cell.config, sc, "cuda"))
            lines.append({"seed": seed, "side": "control", "numbers": got})
            upper = {k: min(upper.get(k, v), v) for k, v in got.items()}
        print(json.dumps(lines[-1]), flush=True)
        del sc, snaps
        torch.cuda.empty_cache()
    lines.append({"workload": args.workload, "lower": lower, "upper": upper,
                  "limits": cell.config["limits"],
                  "device": torch.cuda.get_device_name(0),
                  "power": harness.power_limit(),
                  "seconds": time.perf_counter() - T_START})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
