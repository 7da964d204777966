"""Device ms a substep of the mesh stage (ops/pm_forces.py): the work
inside the program's ranges p3m.cic_scatter, p3m.fft_solve, p3m.cic_gather."""

RANGES = ("p3m.cic_scatter", "p3m.fft_solve", "p3m.cic_gather")


def read(ctx):
    if ctx.window is None:
        return None
    s = ctx.window.inside_s(RANGES)
    return None if not s else s / ctx.window.substeps * 1e3
