"""Device time a request of the operations launched while a function of
``repro_torch/core/plan.py`` (the predicate compile and mask pass) was
running on the host, from the traced segment with Python stacks."""

PLAN = "repro_torch/core/plan.py"


def read(ctx):
    seg = ctx.stacked
    if seg is None or not ctx.stacked_served:
        return None
    sec = seg.under(lambda f: PLAN in f.replace("\\", "/"))
    if not sec:
        return None
    return 1e3 * sec / len(ctx.stacked_served)
