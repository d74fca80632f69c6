"""Share of the plain traced segment in which no operation ran on the
device."""


def read(ctx):
    seg = ctx.plain
    if seg is None or seg.seconds <= 0 or not seg.device:
        return None
    return 1.0 - seg.busy_s / seg.seconds
