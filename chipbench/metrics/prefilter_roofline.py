"""Share of its roofline the exact pre-filter reaches: the least time for
the traced pre-filter-routed queries (``peaks.prefilter_cost`` with the
reference's pass counts) over the device time of the operations launched
while the route, ``HybridIndex.prefilter`` (``repro_torch/core/
index.py``), was running on the host, in the traced segment with Python
stacks.  Whatever implements the route under it is counted."""
from chipbench import peaks

FRAME = "repro_torch/core/index.py"


def read(ctx):
    seg = ctx.stacked
    if seg is None:
        return None
    measured = seg.under(lambda f: FRAME in f.replace("\\", "/")
                         and f.endswith(": prefilter"))
    if not measured:
        return None
    bound = 0.0
    for routes, passing in ctx.stacked_served:
        pre = routes == "prefilter"
        if pre.any():
            bound += peaks.bound_seconds(*peaks.prefilter_cost(
                int(pre.sum()), int(passing[pre].sum()), ctx.corpus_n,
                ctx.corpus_d, ctx.k))
    return peaks.roofline_percent(bound, measured)
