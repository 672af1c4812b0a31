"""
Tracing and profiling: port of ``neural_imaging_tpu/utils/profiling.py``.

- :class:`StepTimer`: per-step wall-clock statistics, synchronized with the
  device of the step's output;
- :func:`trace`: a ``torch.profiler`` session (CPU and CUDA activities) that
  writes a Chrome/Perfetto trace;
- :class:`ScalarLog`: an append-only JSONL scalar log;
- :func:`chip_peaks` and :func:`utilization`: MFU and the HBM share against
  the card's published peaks;
- :func:`step_cost`, :func:`op_traffic` and :func:`compiled_stats`: FLOPs
  and bytes of one call, counted while it runs.

The JAX package reads FLOPs and bytes from XLA's cost analysis of a compiled
program, and ranks the HLO instructions of its ENTRY computation by their
bytes. PyTorch runs eagerly and compiles nothing, so here the call runs once
under two ``TorchDispatchMode``s, below autograd (the backward's operators
are seen too):

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``. It counts matrix
  products and convolutions (a 'SAME' convolution's taps over the padding
  included, as PyTorch counts them; XLA counts only the taps inside the
  image) and no elementwise operator. K1-K4, registered as operators
  (``ops/hopper/registry.py``), are counted by their work functions, on
  which ``chip_smoke.py`` bounds them too: K1 its FLOPs, K2-K4 their issued
  instructions.
- Bytes: every aten operator's input and output tensors (each operator of
  an eager program reads and writes device memory), views and allocations
  without a write excepted; K1-K4 by their work functions. It is the
  counterpart of XLA's "bytes accessed", which counts the same per fused
  instruction.
"""
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula
from torch.utils.module_tracker import ModuleTracker

from neural_imaging_tpu_torch.ops.hopper import codebook, jpeg8x8, registry  # noqa: F401

aten = torch.ops.aten


class StepTimer:
    """Wall-clock timing of train steps with percentile summaries.

    Pass a step's output to ``stop``: the CUDA devices of its tensors are
    synchronized first, so that asynchronous launches do not hide the
    device's time."""

    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._seen = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        if sync_value is not None:
            for device in {t.device for t in tree_flatten(sync_value)[0]
                           if torch.is_tensor(t) and t.is_cuda}:
                torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(elapsed)
        return elapsed

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            'steps': len(arr),
            'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p95_s': float(np.percentile(arr, 95)),
            'steps_per_sec': float(1.0 / arr.mean()),
        }


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA where
    there is a card) and write its Chrome/Perfetto trace to
    ``<log_dir>/trace.json`` (default: a directory under the temporary
    directory); yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), 'ni_torch_trace')
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class ScalarLog:
    """Append-only JSONL scalar log: one record per step ({step, name: value, ...})."""

    def __init__(self, filename):
        self.filename = filename
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        self._fh = open(filename, 'a')

    def log(self, step, **scalars):
        record = {'step': int(step)}
        for k, v in scalars.items():
            record[k] = float(v.detach().cpu()) if torch.is_tensor(v) else float(np.asarray(v))
        self._fh.write(json.dumps(record) + '\n')
        self._fh.flush()

    def close(self):
        self._fh.close()

    @staticmethod
    def read(filename):
        with open(filename) as f:
            return [json.loads(line) for line in f if line.strip()]


# Dense bf16 tensor-core peak (FLOP/s) and HBM bandwidth (B/s) of a card,
# keyed by a lower-case substring of ``torch.cuda.get_device_name``: NVIDIA's
# H100 data sheet, SXM5 at 700 W and PCIe at 350 W.
CHIP_PEAKS = {
    'h100 80gb hbm3': (989.4e12, 3.35e12),
    'h100 pcie': (756e12, 2.0e12),
}


def chip_peaks(device=None):
    """(peak bf16 FLOP/s, peak HBM B/s) of a CUDA device (default: the
    current one), or (None, None) for the CPU and for cards not in
    ``CHIP_PEAKS``."""
    if isinstance(device, int):
        device = torch.device('cuda', device)
    elif device is None:
        if not torch.cuda.is_available():
            return None, None
        device = torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type != 'cuda':
        return None, None
    name = torch.cuda.get_device_name(device).lower()
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return peaks
    return None, None


def utilization(flops_per_step, bytes_per_step, seconds_per_step, device=None):
    """Achieved MFU and HBM-bandwidth fraction against the card's peaks
    (``chip_peaks``); {} for a device without an entry.

    MFU is taken against the dense bf16 peak, as the reference takes it
    against its chip's, whatever the step's precision."""
    peak_flops, peak_bw = chip_peaks(device)
    out = {}
    if peak_flops and flops_per_step and seconds_per_step:
        out['mfu'] = flops_per_step / seconds_per_step / peak_flops
    if peak_bw and bytes_per_step and seconds_per_step:
        out['hbm_util'] = bytes_per_step / seconds_per_step / peak_bw
    return out


def _kernel_formula(work):
    def flops(*shapes, out_shape=None, **kwargs):
        return work(*shapes)[0]
    return flops


# K1-K4's operators count their work (registered once a process)
for _packet, _work in registry.OPS.values():
    if _packet not in flop_registry:
        register_flop_formula(_packet)(_kernel_formula(_work))

# allocations that write nothing
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
               aten.new_empty.default, aten.new_empty_strided.default}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if torch.is_tensor(t))


def _is_view(func):
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Traffic(TorchDispatchMode):
    """Bytes of each operator call: its input and output tensors, or a
    kernel's work function; views, allocations and calls that return no
    tensor add nothing. With ``tracker`` each call is kept as a record
    under the innermost module running it."""

    def __init__(self, tracker=None):
        super().__init__()
        self.total = 0
        self.tracker = tracker
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func in _NO_TRAFFIC or _is_view(func)
                or not any(torch.is_tensor(t) for t in tree_flatten(out)[0])):
            return out
        packet = func._overloadpacket
        kernel = next((work for p, work in registry.OPS.values() if p is packet), None)
        out_bytes = _nbytes(out)
        if kernel is not None:
            shapes = [a.shape if torch.is_tensor(a) else a for a in args]
            n_bytes = kernel(*shapes)[1]
        else:
            n_bytes = _nbytes((args, kwargs)) + out_bytes
        self.total += n_bytes
        if self.tracker is not None:
            parents = sorted(self.tracker.parents - {'Global'},
                             key=lambda name: (name.count('.'), len(name)))
            self.records.append({'name': f'{packet.__name__}.{len(self.records)}',
                                 'op': packet.__name__, 'bytes': n_bytes,
                                 'out_bytes': out_bytes,
                                 'op_name': parents[-1] if parents else ''})
        return out


def _kernel_flops(counter):
    counts = counter.get_flop_counts().get('Global', {})
    return {name: counts[packet] for name, (packet, _) in registry.OPS.items() if packet in counts}


def step_cost(fn, *args):
    """FLOPs and bytes accessed of one call ``fn(*args)``, its backward
    included where it runs one: {'flops', 'bytes_accessed'} (see the module
    docstring for what each counts), and ``flops_by_kernel``, the share of
    the FLOPs that each hand-written kernel launched did ({name: FLOPs}).

    The call runs: a training step updates its model, so count a step that
    is then discarded, or one that is meant to be taken."""
    with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        fn(*args)
    return {'flops': flops.get_total_flops(), 'bytes_accessed': traffic.total,
            'flops_by_kernel': _kernel_flops(flops)}


def op_traffic(fn, *args, top=30):
    """Per-call traffic ranking of one call ``fn(*args)``: a record for each
    aten operator call and kernel launch with its ``name`` (operator and
    call number), ``op``, ``bytes`` (inputs and outputs, or the kernel's
    work), ``out_bytes`` and ``op_name`` (the path of the innermost
    ``nn.Module`` running it, from ``ModuleTracker``'s hooks; '' outside any
    module). Sorted by bytes, descending, cut to ``top``; the first record
    carries ``total_bytes`` and ``n_instructions`` (all calls)."""
    tracker = ModuleTracker()
    with tracker, _Traffic(tracker) as traffic:
        fn(*args)
    records = sorted(traffic.records, key=lambda r: -r['bytes'])
    out = records[:top]
    if out:
        out[0] = dict(out[0], total_bytes=traffic.total, n_instructions=len(records))
    return out


def compiled_stats(fn, *args, **kwargs):
    """``step_cost``'s keys for one call ``fn(*args, **kwargs)``, with the
    argument and output sizes in bytes and, on a card, the call's peak
    device memory above what was allocated before it (``temp_size_bytes``).

    No compilation stands behind it, unlike the reference's XLA analysis:
    the function runs once, eagerly, under the counters."""
    devices = {t.device for t in tree_flatten((args, kwargs))[0]
               if torch.is_tensor(t) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = {device: torch.cuda.memory_allocated(device) for device in devices}
    with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
        result = fn(*args, **kwargs)
    out = {'flops': flops.get_total_flops(), 'bytes_accessed': traffic.total,
           'argument_size_bytes': _nbytes((args, kwargs)), 'output_size_bytes': _nbytes(result)}
    if devices:
        for device in devices:
            torch.cuda.synchronize(device)
        out['temp_size_bytes'] = sum(torch.cuda.max_memory_allocated(d) - before[d]
                                     for d in devices)
    return out
