"""Process start to the window's start: kernel load, corpus, index build,
warm-up."""


def read(ctx):
    return ctx.setup_s
