"""h2d_gbps: the bytes a call that the program copied from the host to the
device (``spans.program_calls``, as ``h2d_copies`` reads them) over the
device time a call of the host→device copies ('Memcpy HtoD' operations) in
the trace of the device alone, in GB/s."""
from benchmark import spans


def read(ctx):
    if ctx.timeline is None or ctx.trace is None:
        return None
    calls = spans.program_calls(ctx.trace.begin, ctx.trace.end)
    _, seconds = spans.htod_per_call(ctx.timeline)
    if not calls or seconds <= 0:
        return None
    return sum(n_bytes for _, n_bytes in calls) / len(calls) / seconds / 1e9
