"""h2d_copies: host→device copies a call: the 'Memcpy HtoD' operations of
the traced calls in the trace of the device alone, over those calls. The
program's own count of its copies (``profiling.to_device``, in its spans)
is held to this one by ``tests/test_bench_spans.py``'s ``gpu`` test. The
profiler at times loses a copy's record, and this count then falls short."""
from benchmark import spans


def read(ctx):
    if ctx.timeline is None:
        return None
    return spans.htod_per_call(ctx.timeline)[0]
