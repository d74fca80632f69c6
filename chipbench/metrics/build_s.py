"""``HybridIndex.build`` on the harness's host clock, synchronised on both
sides."""


def read(ctx):
    return ctx.build_s
