"""Run one cell of the benchmark of nbody_tpu_torch on the CUDA cards here.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's stages and its checks on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last (each number compared
with its limit). Exits non-zero, printing no result, where PyTorch sees no
CUDA card or fewer than the cell asks for, where the program is missing,
or where the process holds JAX or the JAX package once the window has
closed. Kernel builds are kept under ``build/`` of the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this directory: a module here must not shadow
# one of the standard library
sys.path[0] = str(ROOT)
CACHES = {"NBODY_TPU_TORCH_CACHE_DIR": ROOT / "build" / "kernels",
          "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / "build" / "triton"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)

    import torch

    marks = [("import of torch", time.perf_counter())]
    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks.append(("CUDA's start", time.perf_counter()))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START, marks=marks)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: the process holds {', '.join(found)} after the "
              "window; no result", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
