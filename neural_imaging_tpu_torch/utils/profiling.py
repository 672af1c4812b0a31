"""
Tracing and profiling: port of ``neural_imaging_tpu/utils/profiling.py``.

- :func:`span`, :func:`root`, :func:`spanned`, :func:`tracing`,
  :func:`spans`, :func:`clear`: the spans that the program opens at each
  stage of a step or a request, recorded in memory (see below);
- :func:`to_device`: the one helper through which the call path moves host
  data to a card, which counts the copies and their bytes in the open span;
- :func:`trace`: a ``torch.profiler`` session (CPU and CUDA activities) that
  writes a Chrome/Perfetto trace, the spans among its events;
- :class:`ScalarLog`: an append-only JSONL scalar log;
- :func:`chip_peaks` and :func:`utilization`: MFU and the HBM share against
  the card's published peaks;
- :func:`step_cost`, :func:`op_traffic` and :func:`compiled_stats`: FLOPs
  and bytes of one call, counted while it runs.

Spans. ``with span('isp'): ...`` marks a stage. While recording is off, the
default, ``span`` returns one shared object that does nothing: no
allocation, no synchronization, no call into the dispatcher. Recording is
on while :func:`tracing` has turned it on or a ``torch.profiler`` session
runs; each span then keeps a record: its name, its id, its parent's id (a
stack per thread), the id of its root span (``call``: all the spans of one
step or request share it), its start and end, and the host→device copies
made inside it and not inside a child (``h2d_copies``, ``h2d_bytes``).
Times are nanoseconds of ``time.time_ns``, the clock on which
``torch.profiler`` reports its host and device events, so that spans
recorded beside a trace of the device alone line up with its operations.
While a profiler session runs, a span also opens a ``record_function`` of
its name, which the session's trace shows around the operators inside it.
Spans change no arithmetic and read nothing back from the device.

The JAX package reads FLOPs and bytes from XLA's cost analysis of a compiled
program, and ranks the HLO instructions of its ENTRY computation by their
bytes. PyTorch runs eagerly and compiles nothing, so here the call runs once
under two ``TorchDispatchMode``s, below autograd (the backward's operators
are seen too):

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``. It counts matrix
  products and convolutions (a 'SAME' convolution's taps over the padding
  included, as PyTorch counts them; XLA counts only the taps inside the
  image) and no elementwise operator. K1-K4, registered as operators
  (``ops/hopper/registry.py``, which registers their FLOP formulas too),
  are counted by their work functions, on which ``chip_smoke.py`` bounds
  them too: K1 its FLOPs, K2-K4 their issued instructions.
- Bytes: every aten operator's input and output tensors (each operator of
  an eager program reads and writes device memory), views and allocations
  without a write excepted; K1-K4 by their work functions. It is the
  counterpart of XLA's "bytes accessed", which counts the same per fused
  instruction.
"""
import contextlib
import functools
import itertools
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.module_tracker import ModuleTracker

from neural_imaging_tpu_torch.ops.hopper import registry

aten = torch.ops.aten

# -- spans ------------------------------------------------------------------------------

_recording = False
_records = []
_ids = itertools.count(1)
_local = threading.local()


class _NoSpan:
    """What :func:`span` returns while nothing records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:

    def __init__(self, name):
        self.name = name
        self.function = None

    def __enter__(self):
        stack = _stack()
        span_id = next(_ids)
        parent = stack[-1] if stack else None
        self.record = {'name': self.name, 'id': span_id,
                       'parent': None if parent is None else parent['id'],
                       'call': span_id if parent is None else parent['call'],
                       'start': time.time_ns(), 'end': None, 'h2d_copies': 0, 'h2d_bytes': 0}
        _records.append(self.record)
        stack.append(self.record)
        if _autograd_profiler._is_profiler_enabled:
            self.function = record_function(self.name)
            self.function.__enter__()
        return self

    def __exit__(self, *exc):
        if self.function is not None:
            self.function.__exit__(*exc)
        self.record['end'] = time.time_ns()
        _stack().pop()
        return False


def span(name):
    """A context manager that marks the stage ``name`` (see the module docstring)."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name)


def root(name):
    """``span(name)`` where no span is open on this thread, else nothing: the
    root of a call that may also run inside another."""
    if not (_recording or _autograd_profiler._is_profiler_enabled) or _stack():
        return _NO_SPAN
    return _Span(name)


def spanned(name):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def tracing(on=True):
    """Turn the recording of spans on or off (a running ``torch.profiler``
    session records them in any case)."""
    global _recording
    _recording = bool(on)


def spans():
    """The spans recorded since the last :func:`clear`, in the order they
    opened: dicts with 'name', 'id', 'parent', 'call', 'start', 'end' (ns;
    None while open), 'h2d_copies' and 'h2d_bytes'."""
    return list(_records)


def clear():
    """Drop the recorded spans."""
    _records.clear()


# -- host→device copies ----------------------------------------------------------------

def to_device(data, device, dtype=None):
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counted in the
    innermost open span (``h2d_copies``, ``h2d_bytes``) where it copies host
    data to a device: the one way the call path moves host arrays, scalars
    and constants to a card."""
    out = torch.as_tensor(data, dtype=dtype, device=device)
    stack = getattr(_local, 'stack', None)
    if stack and out.device.type != 'cpu' and not (
            torch.is_tensor(data) and data.device == out.device):
        stack[-1]['h2d_copies'] += 1
        stack[-1]['h2d_bytes'] += out.numel() * out.element_size()
    return out


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
