"""K4, the P³M pair kernel (csrc/p3m_pp.cu), over its roofline: the pairs
inside rc that the traced states need, one launch a substep."""

from perfbench.metrics import roofline

KERNEL = "p3m_pp_kernel"


def read(ctx):
    if ctx.window is None:
        return None
    counts = roofline.traced_pair_counts(ctx)
    if counts is None:
        return None
    flops, nbytes = roofline.pair_substep(counts)
    ctx.log(f"k4 pairs inside rc {counts['inside']!r}, kept targets "
            f"{counts['live_t']!r}, kept sources {counts['live_s']!r}")
    return roofline.share(ctx, KERNEL, flops, nbytes, "k4_roofline_pct")
