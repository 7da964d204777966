"""The benchmark's run: set-up, the measured window, the traced window, the
readers of each metric and the judge, for one cell found by name.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that ``BENCHMARK.json`` or another file
gives:

* ``perfbench/configs/<config>.json``: the file the config entry names. It
  names its world factory (``"world"`` → ``perfbench/worlds/<world>.py``)
  and its plain reference (``"reference"`` →
  ``perfbench/reference/<reference>.py``, which owns the substep it judges,
  integrator included).
* ``perfbench/traffic/<traffic>.json``: a traffic mix's parameters. It names
  its driver (``"driver"`` → ``perfbench/drivers/<driver>.py``), which makes
  the warm-up, the window, the traced calls and the states the judge reads.
* ``perfbench/metrics/<metric>.py``: ``read(ctx)`` → a number, or None where
  it finds nothing to read. A metric split by kind of cell
  (``<metric>.<kind>``) takes ``<metric>.py`` where it has no file of its own.

A driver module may hold ``numbers(cfg, scene, snaps, seed, device, post)``
of its own; the others are judged by ``judge.numbers``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import judge, scene, tracing

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "perfbench"
# The program's launch counters, printed over each window on standard error.
COUNTERS = {"nbody_tpu_torch.ops.direct_forces": ("LAUNCHES", "VJP_LAUNCHES"),
            "nbody_tpu_torch.ops.p3m_pp": ("LAUNCHES", "VJP_LAUNCHES")}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, loaded by its file."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"perfbench: no file {path.relative_to(ROOT)}")
    key = f"perfbench.{kind}.{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads``, with its configuration, traffic and the
    metrics it reports."""

    def __init__(self, bench: dict, name: str):
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
        self.entry = work[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def driver(self):
        return module("drivers", self.traffic["driver"])

    def world(self):
        return module("worlds", self.config["world"])

    def numbers(self):
        """The judge's ``numbers`` for this cell's driver."""
        return getattr(self.driver(), "numbers", judge.numbers)


def load_cell(name: str) -> Cell:
    return Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)


def reader(metric: str):
    """``read`` of ``perfbench/metrics/<metric>.py``, else of the file of
    the name before its first dot."""
    name = metric
    if not (BENCH_DIR / "metrics" / f"{name}.py").is_file():
        name = metric.split(".")[0]
    return module("metrics", name).read


def counters() -> dict:
    """{module.counter: value} of the program's launch counters loaded."""
    out = {}
    for mod, names in COUNTERS.items():
        if mod in sys.modules:
            for n in names:
                out[f"{mod.rsplit('.', 1)[-1]}.{n}"] = getattr(sys.modules[mod], n, 0)
    return out


def counted(before: dict, substeps: int) -> str:
    """The counters' growth since ``before``, a substep."""
    after = counters()
    return ", ".join(f"{k} {(after[k] - before.get(k, 0)) / substeps!r}"
                     for k in after) or "none loaded"


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "power limit not read"
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


def simulate(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, marks=None):
    """Set-up, the measured window and, with ``trace``, the traced window:
    (scene, the judge's snapshots, what the readers read). ``marks``:
    [(stage, host clock)] of the set-up before this call."""
    marks = list(marks or [])
    import nbody_tpu_torch as nbt

    marks.append(("import of the program", time.perf_counter()))
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = cell.config
    sc = scene.deployment(cfg["scene"], seed)
    marks.append(("scene", time.perf_counter()))
    world = cell.world().build(nbt, cfg, sc, device)
    drv = cell.driver().Driver(world, cfg, cell.traffic, sync)
    sync()
    marks.append(("world", time.perf_counter()))
    drv.warm()
    sync()
    marks.append(("warm-up call", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    split = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                      in zip([("", t_start)] + marks, marks))
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s ({split} s)")

    before = counters()
    win = drv.window(seconds)
    run_s, substeps = win["run_s"], win["substeps"]
    log(f"launch counters a substep over the window: {counted(before, substeps)}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {run_s:.4f} s, {substeps} substeps, "
        f"{run_s / substeps * 1e3:.6f} ms a substep, host inside the "
        f"program's calls {win['host_s'] / substeps * 1e3:.6f} ms a substep, "
        f"peak {peak} bytes")
    ctx = SimpleNamespace(
        cell=cell, config=cfg, seed=seed, setup_s=setup_s, run_s=run_s,
        substeps=substeps, host_s=win["host_s"], peak=peak, window=None,
        traced_pos=None, gm=drv.init["gm"], radius=drv.init["radius"],
        power="", log=log)
    if trace:
        ctx.power = power_limit()
        ctx.window = tracing.profile(drv.traced, drv.trace_substeps,
                                     warm=drv.call, log=log)
        ctx.traced_pos = drv.traced_ends
        if ctx.window is not None:
            log(f"traced window: {len(ctx.window.work) / ctx.window.substeps!r}"
                " device operations a substep")
    del world, drv
    if cuda:
        torch.cuda.empty_cache()
    return sc, win["snaps"], ctx


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, marks=None) -> dict:
    """One run of ``cell``: the result line's fields, ``checks`` last."""
    sc, snaps, ctx = simulate(cell, seed, seconds, trace, device, t_start,
                              marks)
    device = torch.device(device)
    cuda = device.type == "cuda"
    t_judge = time.perf_counter()
    check = judge.checks(cell.config,
                         cell.numbers()(cell.config, sc, snaps, seed, device))
    correct = judge.passed(check)
    log(f"judged in {time.perf_counter() - t_judge:.1f} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is None:
            log(f"{m['name']}: not measured (nothing to read)")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(ctx.peak)}
    failed = sum(not judge.passed({k: c}) for k, c in check.items())
    out = {"correct": correct, "attempted": ctx.substeps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and ctx.window is not None:
        dev["busy_s"] = ctx.window.busy_s()
        dev["window_s"] = ctx.window.window_s
        out["breakdown"] = ctx.window.breakdown()
    elif trace:
        log("device busy time not measured: every traced window lacked it")
    for k, c in check.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = check
    return out


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not hold:
    JAX, its relatives and the JAX package (names compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & {"jax", "jaxlib", "flax", "nbody_tpu"})
