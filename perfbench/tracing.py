"""The traced window: a ``torch.profiler`` window over some of the
traffic's calls, read into plain lists that the per-layer readers share.

The method is ``chip_smoke.py``'s (``profile_window``, ``profile_stages``):
the profiler on an H100 has dropped a whole window's device events, so a
window without device time is run again, up to ``TRIES`` windows, and one
that never gets it is reported as missing. The program's kernels are
launched through ctypes: they are on the device timeline by name but linked
to no host op, so a kernel's time is found by its name and a stage's by
containment in the device-side span of the program's own
``record_function`` range.
"""

from __future__ import annotations

import time
from bisect import bisect_right

import numpy as np

TRIES = 3
# The harness's own range around the traced calls: the window's bounds on
# the profiler's clock.
WINDOW = "perfbench.window"
# Device events that are spans of record_function ranges, not work.
ANNOTATION = "gpu_user_annotation"
# Entries of each list of the result line's breakdown.
BREAKDOWN_ENTRIES = 10
# Host events searched back from a gap for the one that holds it.
HOST_LOOKBACK = 400


class Window:
    """What one traced window held, in seconds on the profiler's clock:
    ``work`` (name, start, end) of every device kernel, copy and fill;
    ``spans`` {range name: sorted (start, end) arrays} of the ranges' device
    spans; ``host`` (name, start, end, is_range) of host events sorted by
    start; ``window_s`` the host clock over the window (to the sync after
    it), ``event_ms`` the CUDA events' time, ``substeps`` simulated."""

    def __init__(self, events, event_ms: float, substeps: int):
        from torch.autograd import DeviceType

        self.event_ms, self.substeps = event_ms, substeps
        marks = [e for e in events if e.name == WINDOW
                 and e.device_type == DeviceType.CPU]
        if marks:
            lo, hi = marks[0].time_range.start / 1e6, marks[0].time_range.end / 1e6
        else:
            lo, hi = float("-inf"), float("inf")
        self.t0, self.window_s = lo, hi - lo
        self.work, spans, host = [], {}, []
        for e in events:
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.name == WINDOW or b <= lo or a >= hi:
                continue
            a, b = max(a, lo), min(b, hi)
            if e.device_type == DeviceType.CUDA:
                if _is_annotation(e):
                    spans.setdefault(e.name, []).append((a, b))
                elif _is_work(e):
                    self.work.append((e.name, a, b))
            elif e.device_type == DeviceType.CPU:
                host.append((e.name, a, b, _is_range(e)))
        self.work.sort(key=lambda w: w[1])
        self.spans = {k: np.array(sorted(v)) for k, v in spans.items()}
        host.sort(key=lambda h: h[1])
        self.host = host
        self.host_starts = [h[1] for h in host]

    def busy_s(self) -> float:
        """Seconds in which some device work ran: the union of intervals."""
        return sum(b - a for a, b in self.union())

    def union(self) -> list:
        out: list = []
        for _, a, b in self.work:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_s(self, part: str) -> tuple[float, int]:
        """(seconds, launches) of the device work whose name holds ``part``."""
        hits = [b - a for name, a, b in self.work if part in name]
        return sum(hits), len(hits)

    def inside_s(self, names) -> float | None:
        """Seconds of device work inside the device spans of the ranges
        ``names``; None where no such span was recorded."""
        found = [self.spans[n] for n in names if n in self.spans]
        if not found:
            return None
        total = 0.0
        for sp in found:
            starts, ends = sp[:, 0], sp[:, 1]
            for _, a, b in self.work:
                i = bisect_right(starts, a) - 1
                if i >= 0 and b <= ends[i]:
                    total += b - a
        return total

    def breakdown(self) -> dict:
        """The device operations that took most time (kernels by name and
        the ranges' device spans by the work inside them) and the longest
        device idle gaps by what the host was doing then."""
        by_name: dict = {}
        for name, a, b in self.work:
            key = short(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a)
        ranges = {f"range {n}": self.inside_s([n]) for n in self.spans}
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])
        rng = sorted(((k, v) for k, v in ranges.items() if v), key=lambda kv: -kv[1])
        n_rng = min(len(rng), BREAKDOWN_ENTRIES // 2)
        device_ops = ops[:BREAKDOWN_ENTRIES - n_rng] + rng[:n_rng]
        gaps: dict = {}
        union = self.union()
        edges = [(self.t0, union[0][0])] if union else []
        edges += [(x[1], y[0]) for x, y in zip(union, union[1:])]
        for a, b in edges:
            if b > a:
                key = self.host_at(0.5 * (a + b))
                gaps[key] = gaps.get(key, 0.0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[k, v] for k, v in device_ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def host_at(self, t: float) -> str:
        """The innermost range and the innermost op running on the host at
        ``t``, as "range > op"."""
        i = bisect_right(self.host_starts, t) - 1
        rng = op = None
        for name, a, b, is_range in reversed(self.host[max(0, i - HOST_LOOKBACK):i + 1]):
            if b < t:
                continue
            if is_range and rng is None:
                rng = name
            elif not is_range and op is None:
                op = name
            if rng and op:
                break
        return f"{rng or 'no range'} > {op or 'Python between ops'}"


def _activity(e) -> str:
    return str(getattr(e, "activity_type", None) or "")


def _is_annotation(e) -> bool:
    """A device-side span of a record_function range."""
    return _activity(e) == ANNOTATION or bool(getattr(e, "is_user_annotation", False))


def _is_range(e) -> bool:
    """A host-side record_function range (the program's p3m.*, the
    harness's perfbench.*), not an operator or a runtime call."""
    return (_activity(e) == "user_annotation"
            or bool(getattr(e, "is_user_annotation", False))
            or ("." in e.name and "::" not in e.name
                and not e.name.startswith("cuda")))


def _is_work(e) -> bool:
    """Device work: a kernel, a copy or a fill (not a wait on the host)."""
    return "sync" not in _activity(e)


def short(name: str) -> str:
    """A kernel's name without its return type and parameter list, at most
    120 letters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:120]


def profile(fn, substeps: int, warm=None, tries: int = TRIES, log=print):
    """``fn()`` in a profiler window with CUDA events around it, until a
    window holds device work (at most ``tries``); ``warm()`` runs first in
    the profiler but outside the window, so that the profiler's own start
    (its buffers, the allocator's first blocks) falls outside it. The
    window is the harness's range ``WINDOW``, from the first call to the
    sync after the last. Returns the Window, or None where every window
    lacked device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx, record_function

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            if warm is not None:
                warm()
            torch.cuda.synchronize()
            with record_function(WINDOW):
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
        t_read = time.perf_counter()
        w = Window(prof.events(), start.elapsed_time(end), substeps)
        log(f"traced window {attempt}: {len(w.work)} device ops, "
            f"{w.window_s:.6f} s, read in {time.perf_counter() - t_read:.1f} s")
        if len(w.work) >= substeps and w.busy_s() > 0:
            return w
        log(f"traced window {attempt} of {tries} held too little device time")
    return None
