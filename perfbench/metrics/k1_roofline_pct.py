"""K1, the fused direct substep (csrc/direct_forces.cu), over its roofline:
each traced launch is one substep's pairs."""

from perfbench.metrics import roofline

KERNEL = "direct_forces_kernel"


def read(ctx):
    if ctx.window is None:
        return None
    n, s = ctx.radius.shape[0], ctx.gm.shape[0]
    flops, nbytes = roofline.direct_substep(n, s)
    return roofline.share(ctx, KERNEL, flops, nbytes, "k1_roofline_pct")
