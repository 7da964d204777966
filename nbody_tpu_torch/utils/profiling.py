"""Profiling helpers: wall-clock step timing and torch.profiler traces.

Counterpart of ``nbody_tpu/utils/profiling.py``. The reference's only
instrumentation is CLOCK_MONOTONIC wall timing in bench.c; here the same
style of timer, which waits for the card's work on the tensors it is
given, plus Chrome traces of ``torch.profiler`` (CPU, and CUDA where
present) viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


def block_until_ready(tree) -> None:
    """Wait for the CUDA work behind every tensor in ``tree`` (tensors, and
    dataclasses such as Particles, lists, tuples and dicts of them):
    ``torch.cuda.synchronize`` of each card they are on, nothing for CPU
    tensors."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    for device in devices:
        torch.cuda.synchronize(device)


@dataclass
class StepTimer:
    """Accumulates per-call wall times of blocking device work."""

    times_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self, tree_to_block=None):
        t0 = time.perf_counter()
        yield
        if tree_to_block is not None:
            block_until_ready(tree_to_block)
        self.times_s.append(time.perf_counter() - t0)

    @property
    def mean_us(self) -> float:
        return 1e6 * sum(self.times_s) / max(1, len(self.times_s))

    @property
    def best_us(self) -> float:
        return 1e6 * min(self.times_s) if self.times_s else 0.0

    def summary(self) -> str:
        return f"{len(self.times_s)} calls, mean {self.mean_us:.1f} µs, best {self.best_us:.1f} µs"


@contextlib.contextmanager
def trace(log_dir=DEFAULT_TRACE_DIR):
    """Capture a torch.profiler trace (CPU, and CUDA when a card is there)
    around a block of work; on exit it is written into ``log_dir`` as a
    Chrome trace, ``trace-<pid>-<ns>.json``. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)
