"""Seconds from the start of the process to the first timed call: the
imports, CUDA's start, finding or building the kernels, the scene, the
world and the warm-up."""


def read(ctx):
    return ctx.setup_s
