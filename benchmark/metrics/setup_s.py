"""setup_s: host seconds from the start of the process to the first timed
call: imports, the program's kernels built or loaded, weights and inputs
made, the first steps and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
