"""Share of the P3M targets past a full cell over the spans window:
100 × the program's counter p3m.dropped_targets / p3m.targets. The pair
kernel leaves those rows the mesh force alone."""

from perfbench import spans


def read(ctx):
    return spans.counted_pct(ctx, "p3m.dropped_targets", "p3m.targets")
