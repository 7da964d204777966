"""Device ms a substep of the cell bins and rows (ops/p3m_forces.py): the
work inside the program's ranges p3m.bins, p3m.pack, p3m.unpack."""

RANGES = ("p3m.bins", "p3m.pack", "p3m.unpack")


def read(ctx):
    if ctx.window is None:
        return None
    s = ctx.window.inside_s(RANGES)
    return None if not s else s / ctx.window.substeps * 1e3
