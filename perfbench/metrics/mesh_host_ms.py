"""Host ms a substep inside the program's spans p3m.cic_scatter,
p3m.fft_solve and p3m.cic_gather (the mesh stage), over the spans window
(perfbench/spans.py)."""

from perfbench import spans

NAMES = ("p3m.cic_scatter", "p3m.fft_solve", "p3m.cic_gather")


def read(ctx):
    return spans.host_ms(ctx, NAMES)
