"""Profiling helpers: wall-clock step timing, torch.profiler traces and
the program's tracer.

Counterpart of ``nbody_tpu/utils/profiling.py``. The reference's only
instrumentation is CLOCK_MONOTONIC wall timing in bench.c; here the same
style of timer, which waits for the card's work on the tensors it is
given, plus Chrome traces of ``torch.profiler`` (CPU, and CUDA where
present) viewable in Perfetto or chrome://tracing.

The tracer. The program names its stages with :func:`span` (``p3m.*``,
``merge_pass``, ``shards.sum``) and its layers with ``span(name,
profiled=False)`` (``world.update``, ``substep``, ``k1.launch``):

* off, and no profiler window active: a shared no-op context, one flag
  check, and for a stage one ``torch._C._autograd._profiler_enabled()``
  call;
* a ``torch.profiler`` window active: for a stage,
  ``record_function(name)``, so the range appears in the profile under
  the same name; a layer's span opens no range, so a profile holds the
  stages' ranges alone;
* on (:func:`enable`): besides, a :class:`Span` (name, enclosing span,
  ``time.perf_counter_ns`` start and end, substep index) appended to a
  list in memory. Nothing is written to disk and nothing waits for the
  device.

:func:`count` adds to a named counter while the tracer is on: a host int,
or a 0-dim device tensor summed on the device and read back only by
:func:`collect`, so a traced substep loop never syncs. :func:`collect`
returns the spans, the counters and the clock anchor, then clears them.
The anchor is a pair (``time.time_ns()``, ``time.perf_counter_ns()``)
taken by :func:`enable`: Kineto's ``trace_start_ns()`` is on
``time.time_ns``'s clock, so :func:`wall_ns` puts a span on a profile's
timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch
from torch.profiler import record_function

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


# --- the tracer ---

SUBSTEP = "substep"
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled

_on = False
_anchor = (0, 0)
_spans: list = []   # [name, parent, start_ns, end_ns, step] a span
_open: list = []    # indices into _spans of the open spans, innermost last
_counts: dict = {}
_step = -1          # the innermost open substep's index, -1 outside one
_steps = 0          # substeps opened since enable()


class Span(NamedTuple):
    name: str
    parent: int     # index of the enclosing span in the same list, -1 if none
    start_ns: int   # time.perf_counter_ns()
    end_ns: int
    step: int       # index of the substep it ran in, -1 outside every substep


class _Recorded:
    """A span while the tracer is on: a record in ``_spans``, and, for a
    stage, the profiler's range where a profiler window is active. A
    ``substep`` span opens the next substep index: the spans inside it
    carry that index."""

    __slots__ = ("name", "profiled", "rec", "outer", "rf")

    def __init__(self, name: str, profiled: bool):
        self.name, self.profiled = name, profiled

    def __enter__(self):
        global _step, _steps
        self.rf = None
        if self.profiled and _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.outer = _step
        if self.name == SUBSTEP:
            _step, _steps = _steps, _steps + 1
        self.rec = [self.name, _open[-1] if _open else -1,
                    time.perf_counter_ns(), 0, _step]
        _open.append(len(_spans))
        _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        global _step
        self.rec[3] = time.perf_counter_ns()
        _open.pop()
        _step = self.outer
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str | None, profiled: bool = True):
    """A named region: recorded while the tracer is on, a
    ``record_function`` range while a profiler window is active (unless
    ``profiled`` is False: the tracer alone sees it), else a no-op.
    ``None`` is always a no-op (a stage that has no name on some path)."""
    if name is None:
        return _NULL
    if _on:
        return _Recorded(name, profiled)
    if profiled and _profiler_enabled():
        return record_function(name)
    return _NULL


annotate = span


def enable() -> None:
    """Turn the tracer on, anchor its clock and start the substep indices
    at 0."""
    global _on, _anchor, _step, _steps
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _step, _steps = -1, 0
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-dim tensor, added on its device) to
    the counter ``name`` while the tracer is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + value


def collect() -> dict:
    """{"spans": [Span], "counts": {name: int}, "anchor": (time_ns,
    perf_counter_ns)}; the spans and counters are then cleared. Device
    counters are read back here, one sync each. Call it outside every
    span."""
    spans = [Span(*rec) for rec in _spans]
    counts = {k: int(v.item()) if isinstance(v, torch.Tensor) else int(v)
              for k, v in _counts.items()}
    _spans.clear()
    _counts.clear()
    return {"spans": spans, "counts": counts, "anchor": _anchor}


def wall_ns(t_ns: int, anchor) -> int:
    """A ``perf_counter_ns`` time on ``time.time_ns``'s clock, through the
    anchor that :func:`collect` returned; minus a profile's
    ``prof.profiler.kineto_results.trace_start_ns()`` it is on that
    profile's event clock."""
    return anchor[0] + t_ns - anchor[1]
