"""Host ms a substep inside the program's spans p3m.bins, p3m.pack and
p3m.unpack (the cell bins and rows: the ranges bins_ms reads on the
device), over the spans window (perfbench/spans.py)."""

from perfbench import spans

NAMES = ("p3m.bins", "p3m.pack", "p3m.unpack")


def read(ctx):
    return spans.host_ms(ctx, NAMES)
