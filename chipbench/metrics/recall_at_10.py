"""Mean recall@10 of the checked requests' queries against the
reference's exact answer."""


def read(ctx):
    return ctx.recall
