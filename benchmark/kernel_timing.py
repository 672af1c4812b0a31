"""
Device time of the program's hand-written kernels (K1-K4) at given shapes,
each launch timed alone by CUDA events with the L2 cache flushed before it
and queued behind a device-side spin, so that no host time falls between
the events (the method of the port's ``chip_smoke.py::time_ms``, copied).

The traced run reads its K1-K4 shapes from the program's launch counters and
times them here, on inputs made here: the profiler's in-place kernel times
read below what HBM allows where a kernel's input still sits in L2 from the
operation before it, which no bound from the card's peaks can hold.
"""
import numpy as np
import torch

from benchmark.reference import dcn as dcn_ref
from benchmark.reference import jpeg as jpeg_ref

FLUSH_BYTES = 256 << 20          # five times the H100's 50 MB L2
SPIN_CYCLES = 200_000            # ~0.1 ms at 1.98 GHz, more than a launcher's host time
MAX_SPIN_CYCLES = 64 * SPIN_CYCLES
REPS = 20


def time_ms(fn, flush, reps=REPS):
    """Median device ms of ``fn`` over ``reps`` launches, each alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SPIN_CYCLES
    while len(times) < reps:
        flush.zero_()
        torch.cuda._sleep(cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            times.append(start.elapsed_time(end))
        elif cycles < MAX_SPIN_CYCLES:
            cycles *= 2
        else:
            raise RuntimeError('the host did not queue the timed launch within the spin')
    return float(np.median(times))


def _launch(kernel, shape, codes, gen, device):
    """A launch of ``kernel`` ('k1'-'k4') at ``shape`` on inputs drawn from ``gen``."""
    from neural_imaging_tpu_torch.ops.hopper import codebook, jpeg8x8
    if kernel == 'k1':
        p, h, w = shape
        planes = torch.rand((p, h, w), generator=gen, device=device) * 255 - 127
        tables = torch.stack([torch.as_tensor(jpeg_ref.qtable(50, c == 0), device=device)
                              for c in range(3)])
        q = tables.repeat(-(-p // 3), 1, 1)[:p].contiguous()
        return lambda: jpeg8x8.jpeg_core_cuda(planes, q)
    n = shape
    cb = torch.as_tensor(dcn_ref.codebook(int(np.log2(codes))), device=device)
    z = 4 * torch.randn(n, generator=gen, device=device)
    g = torch.randn(n, generator=gen, device=device)
    per_codeword = 1e-3 * torch.randn(codes, generator=gen, device=device)
    if kernel == 'k2':
        return lambda: codebook.codebook_fwd_cuda(z, cb)
    if kernel == 'k3':
        return lambda: codebook.codebook_bwd_cuda(z, g, cb, per_codeword)
    return lambda: codebook.codebook_bwd_train_cuda(z, g, cb, per_codeword)


def kernel_ms(launches, codes, device, seed=0):
    """{kernel: {shape: ms}} for every shape in ``launches`` ({kernel: Counter})."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {k: {shape: time_ms(_launch(k, shape, codes, gen, device), flush)
               for shape in sizes} for k, sizes in launches.items() if sizes}
    del flush
    return out
