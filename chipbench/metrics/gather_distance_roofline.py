"""Share of its roofline the ``gather_distance`` kernel reaches: the
bytes of the fresh distances the traced graph-routed queries computed
(``dist_comps``) at the HBM rate, over the kernel's device time by name
in the plain traced segment."""
from chipbench import peaks


def read(ctx):
    seg = ctx.plain
    if seg is None:
        return None
    measured = seg.kernel_seconds(lambda name: "gather_distance" in name)
    dc = sum(int(s.dist_comps[s.routes == "graph"].sum())
             for s in ctx.plain_served)
    flops, nbytes = peaks.gather_distance_cost(dc, ctx.corpus_d)
    return peaks.roofline_percent(peaks.bound_seconds(flops, nbytes),
                                  measured)
