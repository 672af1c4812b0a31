"""latency_ms_p95: the 95th percentile of every call's time in the window,
from the stream mark recorded before the call to the next one (the last
call: to the window's closing mark)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_ms), 95))
