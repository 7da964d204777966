"""The window's wall time over the substeps it simulated, in ms: host
clock from the first call to the sync after the last, all the work and
all the time of the window. A gradient iteration would count the forward
substeps of its rollout."""


def read(ctx):
    return ctx.run_s / ctx.substeps * 1e3
