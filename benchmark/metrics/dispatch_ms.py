"""dispatch_ms: mean host ms from a call of the cell's entry to its return,
over the measured window (the benchmark's host clock around each call)."""


def read(ctx):
    return sum(ctx.dispatch_ms) / len(ctx.dispatch_ms) if ctx.dispatch_ms else None
