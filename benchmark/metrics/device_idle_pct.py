"""device_idle_pct: the share of the traced window (the device-only trace,
between its two end spins) that no device operation covers: the union of
the operations' intervals, so overlapping operations count once."""


def read(ctx):
    if ctx.timeline is None or not ctx.timeline.ops:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy_s / ctx.timeline.window_s)
