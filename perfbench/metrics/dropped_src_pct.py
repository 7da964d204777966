"""Share of the P3M sources past a full cell over the spans window:
100 × the program's counter p3m.dropped_sources / p3m.sources. Their
close pairs keep the mesh force alone."""

from perfbench import spans


def read(ctx):
    return spans.counted_pct(ctx, "p3m.dropped_sources", "p3m.sources")
