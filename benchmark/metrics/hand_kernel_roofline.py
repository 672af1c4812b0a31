"""hand_kernel_roofline: the least time of every K1-K4 launch in the traced
calls (``work.py``; each launch's shape from the program's launch counters)
over the same launches' device time, each shape timed alone by CUDA events
with L2 flushed (``kernel_timing.py``), as a share."""
from benchmark import work

WORK = {'k1': lambda shape, codes: work.k1(*shape), 'k2': lambda n, codes: work.k2(n, codes),
        'k3': lambda n, codes: work.k3(n, codes), 'k4': lambda n, codes: work.k4(n, codes)}


def read(ctx):
    if not ctx.kernel_ms or ctx.peaks is None:
        return None
    bound = spent = 0.0
    for k, sizes in ctx.launches.items():
        for shape, count in sizes.items():
            bound += count * work.bound_s(WORK[k](shape, ctx.codes), ctx.peaks)
            spent += count * ctx.kernel_ms[k][shape] / 1e3
    return 100.0 * bound / spent if spent > 0 else None
