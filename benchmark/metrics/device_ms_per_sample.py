"""device_ms_per_sample: the device's busy ms a sample: the union of the
device operations' intervals in the device-only trace of the cell's traced
calls (overlapping operations count once), over the samples those calls
took. What the card spends on a sample, whatever the host's pace: in a cell
that the host paces, the window's rate reads the host."""

TRACED = True


def read(ctx):
    t = ctx.timeline
    if t is None or not t.ops:
        return None
    return 1e3 * t.busy_s / (t.n_calls * ctx.samples)
