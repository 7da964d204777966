"""Host ms a substep inside World.update (world.py) over the measured
window's own calls, with no sync: the host's enqueue where the host sets
the pace, and the device's pace where the device does (the host then waits
inside World.update for room in CUDA's launch queue). It is at most
``substep_ms`` of the same window, which also holds the harness's own
work between the calls."""


def read(ctx):
    if not ctx.substeps:
        return None
    return ctx.host_s / ctx.substeps * 1e3
