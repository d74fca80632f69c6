"""Queries completed in the window over the window's seconds."""


def read(ctx):
    return ctx.queries / ctx.window_s if ctx.window_s > 0 else None
