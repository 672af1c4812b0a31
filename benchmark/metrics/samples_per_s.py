"""samples_per_s: the patches that all the window's calls took, over the
host seconds from the window's start to a synchronize after its last call."""


def read(ctx):
    return ctx.samples * ctx.n_calls / ctx.window_s
