"""The spans window's readers (perfbench/spans.py and the metrics that
read the program's spans and counters) on synthetic spans, and the
harness's traced run against the program and against a stub of it that
has no tracer."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, spans, tracing

Span = spans.Span
MS = 1_000_000  # ns


def ctx_of(span_list, counts=None):
    rec = {"spans": span_list, "counts": counts or {}, "anchor": (0, 0),
           "wall_s": 1.0, "substeps": 2}
    return SimpleNamespace(spans=rec)


def two_substeps():
    """One world.update of two substeps, 10 ms each: p3m.bins 2 ms with a
    nested p3m.bins 1 ms inside it, p3m.cic_scatter 3 ms, p3m.pair_kernel
    1 ms holding k1.launch, and 4 ms a substep outside every stage."""
    out = [Span("world.update", -1, 0, 20 * MS, -1)]
    for k in range(2):
        t = 10 * MS * k
        sub = len(out)
        out.append(Span("substep", 0, t, t + 10 * MS, k))
        bins = len(out)
        out.append(Span("p3m.bins", sub, t, t + 2 * MS, k))
        out.append(Span("p3m.bins", bins, t + MS // 2, t + 3 * MS // 2, k))
        out.append(Span("p3m.cic_scatter", sub, t + 2 * MS, t + 5 * MS, k))
        pp = len(out)
        out.append(Span("p3m.pair_kernel", sub, t + 5 * MS, t + 6 * MS, k))
        out.append(Span("k1.launch", pp, t + 5 * MS, t + 6 * MS, k))
    return out


def read(metric, ctx):
    return harness.reader(metric)(ctx)


def test_host_readers_count_a_nested_span_once():
    ctx = ctx_of(two_substeps())
    assert read("bins_host_ms", ctx) == pytest.approx(2.0)
    assert read("mesh_host_ms", ctx) == pytest.approx(3.0)
    assert read("pp_host_ms", ctx) == pytest.approx(1.0)
    assert read("loop_self_ms.p3m", ctx) == pytest.approx(4.0)
    assert read("loop_self_ms.direct", ctx) == pytest.approx(4.0)
    total = sum(read(m, ctx) for m in ("bins_host_ms", "mesh_host_ms",
                                       "pp_host_ms", "loop_self_ms.p3m"))
    update = spans.per_substep_ms(ctx.spans, spans.length(
        spans.intervals(ctx.spans["spans"], {spans.UPDATE})))
    assert total == pytest.approx(update) == pytest.approx(10.0)


def test_readers_find_nothing_without_spans():
    for rec in (None, {"spans": [], "counts": {}}):
        ctx = SimpleNamespace(spans=rec)
        for m in ("bins_host_ms", "mesh_host_ms", "pp_host_ms",
                  "loop_self_ms.direct", "dropped_tgt_pct", "dropped_src_pct"):
            assert read(m, ctx) is None, (m, rec)
    # a direct substep loop has no p3m.* stage to read
    direct = [Span("world.update", -1, 0, 4 * MS, -1),
              Span("substep", 0, 0, 4 * MS, 0),
              Span("k1.launch", 1, MS, 4 * MS, 0)]
    ctx = ctx_of(direct)
    assert read("bins_host_ms", ctx) is None
    assert read("loop_self_ms.direct", ctx) == pytest.approx(1.0)


def test_dropped_shares_read_the_counters():
    ctx = ctx_of(two_substeps(), {"p3m.targets": 4000, "p3m.sources": 2000,
                                  "p3m.dropped_targets": 30,
                                  "p3m.dropped_sources": 0})
    assert read("dropped_tgt_pct", ctx) == pytest.approx(0.75)
    assert read("dropped_src_pct", ctx) == 0.0
    assert read("dropped_src_pct", ctx_of(two_substeps(), {})) is None


def test_kernel_load_s_sums_the_programs_loads(monkeypatch):
    key = "nbody_tpu_torch.ops._build"
    monkeypatch.setitem(sys.modules, key,
                        SimpleNamespace(LOADED={"a": 0.25, "b": 1.5}))
    assert read("kernel_load_s", SimpleNamespace()) == pytest.approx(1.75)
    monkeypatch.setitem(sys.modules, key, SimpleNamespace())
    assert read("kernel_load_s", SimpleNamespace()) is None
    monkeypatch.setitem(sys.modules, key, SimpleNamespace(LOADED={}))
    assert read("kernel_load_s", SimpleNamespace()) is None


def test_stall_report_names_the_stage_that_held_the_longest_substep():
    out = two_substeps()
    # the second substep's scatter takes 20 ms longer
    out = [s._replace(end_ns=s.end_ns + 20 * MS)
           if s.name in ("substep", "p3m.cic_scatter", "world.update")
           and s.step in (1, -1) else s for s in out]
    rows = {r[0]: r for r in spans.stalls({"spans": out})}
    name, k, med, worst, step, stage, ms, usual = rows["substep"]
    assert (k, step, stage) == (2, 1, "p3m.cic_scatter")
    assert worst == pytest.approx(30.0) and ms == pytest.approx(23.0)
    assert usual == pytest.approx(13.0)  # the median of 3 and 23
    assert rows["world.update"][5] == "p3m.cic_scatter"


def traced_run(monkeypatch, cell_name="direct-65k.run"):
    """A traced CPU run of a small cell on the plain PyTorch backend (the
    spans window's process knows no test's patches); the profiler window
    (the card's) is left out, as when every window lacked device time."""
    from perfbench.tests.conftest import small_cell

    monkeypatch.setattr(tracing, "profile", lambda *a, **k: None)
    monkeypatch.setattr(harness, "power_limit", lambda: "not read")
    monkeypatch.setattr(spans, "SPAN_CALLS", 3)
    cell = small_cell(cell_name)
    cell.config = dict(cell.config, backend="torch")
    return harness.run(cell, 2**31 + 99, 0.1, True, "cpu",
                       time.perf_counter())


def test_traced_run_reports_the_programs_spans(monkeypatch):
    """The spans window runs in a process of its own and hands back the
    window's spans: 3 calls of 4 substeps under 3 world.update calls."""
    out = traced_run(monkeypatch)
    assert out["correct"]
    assert set(out["metrics"]) == {"enqueue_ms.direct", "loop_self_ms.direct"}
    assert out["metrics"]["loop_self_ms.direct"]["value"] > 0


def test_spans_window_process_returns_the_window(monkeypatch):
    from perfbench.tests.conftest import small_cell

    monkeypatch.setattr(spans, "SPAN_CALLS", 2)
    cell = small_cell("direct-65k.run")
    cell.config = dict(cell.config, backend="torch")
    logged = []
    ctx = SimpleNamespace(cell=cell, config=cell.config, seed=7,
                          gm=torch.zeros(1), run_s=1.0,
                          substeps=10, log=logged.append)
    rec = spans.of(ctx)
    assert spans.of(ctx) is rec and rec["substeps"] == 8
    names = [s.name for s in rec["spans"]]
    assert names.count("world.update") == 2 and names.count("substep") == 8
    assert all(isinstance(s, spans.Span) for s in rec["spans"])
    assert any(line.startswith("stall report") for line in logged)


def test_traced_run_against_a_program_without_a_tracer(monkeypatch):
    """The parent commit's program has no tracer and no LOADED: the new
    metrics are not measured and the others are as they were."""
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    monkeypatch.delattr(_build, "LOADED")
    out = traced_run(monkeypatch)
    assert out["correct"]
    assert set(out["metrics"]) == {"enqueue_ms.direct"}
