"""Host ms a substep inside the program's spans p3m.pair_kernel and
p3m.exact_rows (K4's launch and the exact-core rows through K1), over the
spans window (perfbench/spans.py)."""

from perfbench import spans

NAMES = ("p3m.pair_kernel", "p3m.exact_rows")


def read(ctx):
    return spans.host_ms(ctx, NAMES)
