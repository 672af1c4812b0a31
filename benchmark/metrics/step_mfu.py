"""step_mfu: the reference's FLOPs a call (``FlopCounterMode`` over the
benchmark's own reference call at the cell's shapes) times the calls of the
device-only trace, over its window, as a share of the card's dense bfloat16
peak."""


def read(ctx):
    t = ctx.timeline
    if t is None or not t.ops or not ctx.reference_flops or ctx.peaks is None:
        return None
    return 100.0 * ctx.reference_flops * t.n_calls / t.window_s / ctx.peaks['bf16_flops']
