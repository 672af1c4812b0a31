"""
The traced part of a ``--trace 1`` run: calls of the cell's entry under
``torch.profiler``, with the forward and backward of the program's layers
marked from the benchmark's own module hooks, reduced to what the per-layer
readers (``metrics/<name>.py``) read.

Marks. A layer is a run of the program's modules, from a first to a last
(``layers`` in the configuration file, by attribute path on the flow). Its
forward runs from the first module's forward pre-hook to the last module's
forward hook; its backward from the moment the gradients of the last
module's outputs are ready to the moment those of the first module's inputs
are, or, where no input needs one, to the end of the backward pass. Each
moment is a zero-length ``record_function`` event in the profiler's clock.

Two runs. See ``traced_calls``.

Attribution. Each device operation is linked by the profiler to the host
operator that launched it; the operation belongs to the layer whose marks
enclose that operator's start on the host. Device times are the operations'
own durations.
"""
import bisect
import collections

import torch
from torch.autograd.graph import register_multi_grad_hook
from torch.profiler import ProfilerActivity, profile, record_function

MARK = 'bench.mark/'
WINDOW_BEGIN, WINDOW_END = 'bench.window.begin', 'bench.window.end'
TOP = 10


def _mark(name):
    with record_function(MARK + name):
        pass


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value] if value.requires_grad else []
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return []


class LayerMarks:
    """Hooks that mark each layer's forward and backward; ``remove`` takes them off."""

    def __init__(self, layers):
        """``layers``: {name: (first module, last module)}."""
        self.handles = []
        for name, (first, last) in layers.items():
            self._hook(name, first, last)

    def _hook(self, name, first, last):
        pending = {}

        def pre(module, args):
            _mark(f'{name}/fwd.begin')
            pending['inputs'] = _tensors(args)

        def post(module, args, output):
            _mark(f'{name}/fwd.end')
            outputs = _tensors(output)
            inputs = pending.pop('inputs', [])
            if not outputs:
                return

            def backward_begins(*_):
                _mark(f'{name}/bwd.begin')
                torch.autograd.Variable._execution_engine.queue_callback(
                    lambda: _mark(f'{name}/bwd.end'))
            register_multi_grad_hook(outputs, backward_begins)
            if inputs:
                register_multi_grad_hook(inputs, lambda *_: _mark(f'{name}/bwd.end'))

        self.handles.append(first.register_forward_pre_hook(pre))
        self.handles.append(last.register_forward_hook(post))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def _ns(event, what):
    method = getattr(event, f'{what}_ns', None)
    return method() if method is not None else 1000 * getattr(event, f'{what}_us')()


def _is_device(event):
    return event.device_type() == torch.autograd.DeviceType.CUDA and not (
        getattr(event, 'is_user_annotation', lambda: False)()
        or event.name().startswith(('bench.', 'ProfilerStep', 'Optimizer.')))


def device_only_calls(entry, state, n_calls, device):
    """``n_calls`` calls traced with the device's operations alone, between
    two spin kernels launched at their ends, as a ``Trace``; None off the
    card."""
    if device.type != 'cuda':
        return None
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(n_calls):
            entry.call(state)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
    return Trace(prof.profiler.kineto_results.events(), n_calls)


def traced_calls(entry, state, n_calls, layers, device):
    """Two traced runs of ``n_calls`` calls each: (the device alone, the device
    with the host's operators and the layers' marks), as ``Trace``s.

    Recording every host operator slows the host by some microseconds an
    operator, which a host-bound call feels, so the share of the window that
    the device is busy, and the operations' times, come from the first run,
    which records the device alone between two spin kernels launched at its
    ends; the layers' times and the labels of the idle gaps come from the
    second."""
    cuda = device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    light = device_only_calls(entry, state, n_calls, device)
    marks = LayerMarks(layers)
    sync()
    try:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW_BEGIN):
                pass
            for _ in range(n_calls):
                entry.call(state)
            sync()
            with record_function(WINDOW_END):
                pass
    finally:
        marks.remove()
    return light, Trace(prof.profiler.kineto_results.events(), n_calls)


class Trace:
    """A traced window reduced to: its length, the device operations (name,
    start, end, layer, the host operator that launched them), their union
    (busy time) and the idle gaps between them."""

    def __init__(self, events, n_calls):
        """The window runs between the WINDOW_BEGIN and WINDOW_END marks, or,
        where the host was not recorded, from the first device operation's
        start to the last one's end."""
        self.n_calls = n_calls
        marks, frontend, device = [], {}, []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if name.startswith(MARK) or name in (WINDOW_BEGIN, WINDOW_END):
                    marks.append((_ns(e, 'start'), name))
                elif e.linked_correlation_id() == 0:
                    frontend[e.correlation_id()] = (_ns(e, 'start'), name)
            elif _is_device(e):
                start = _ns(e, 'start')
                device.append((start, start + _ns(e, 'duration'), name, e.linked_correlation_id()))
        marks.sort()
        ends = dict((n, t) for t, n in marks)
        self.begin = ends.get(WINDOW_BEGIN, min((d[0] for d in device), default=0))
        self.end = ends.get(WINDOW_END, max((d[1] for d in device), default=0))
        self.window_s = (self.end - self.begin) / 1e9
        self.ranges = _ranges(marks)
        starts = [r[0] for r in self.ranges]
        self.ops = []
        for start, end, name, corr in sorted(device):
            start, end = max(start, self.begin), min(end, self.end)
            if end <= start:
                continue
            host = frontend.get(corr)
            layer = None
            if host is not None:
                i = bisect.bisect_right(starts, host[0]) - 1
                if i >= 0 and host[0] <= self.ranges[i][1]:
                    layer = self.ranges[i][2]
            self.ops.append({'name': name, 'start': start, 'end': end, 'layer': layer,
                             'host': host[1] if host else None})
        self.busy_s, self.gaps = self._union()

    def _union(self):
        busy, gaps, cursor = 0, [], self.begin
        for op in self.ops:
            if op['start'] > cursor:
                gaps.append((op['start'] - cursor, op))
            if op['end'] > cursor:
                busy += op['end'] - max(op['start'], cursor)
                cursor = op['end']
        if self.end > cursor:
            gaps.append((self.end - cursor, None))
        return busy / 1e9, gaps

    def layer_ms(self, layer):
        """Device ms a call of the operations launched inside ``layer``'s
        marks (forward and backward), or None where none were."""
        ns = [op['end'] - op['start'] for op in self.ops if op['layer'] == layer]
        return sum(ns) / 1e6 / self.n_calls if ns else None

    def kernel_s(self, substrings):
        """Device seconds of the operations whose names hold one of ``substrings``."""
        return sum(op['end'] - op['start'] for op in self.ops
                   if any(s in op['name'] for s in substrings)) / 1e9

    def top_ops(self):
        """The device operations that took most time: [[name, seconds]]."""
        by_op = collections.Counter()
        for op in self.ops:
            by_op[op['name'][:120]] += (op['end'] - op['start']) / 1e9
        return [[k, v] for k, v in by_op.most_common(TOP)]

    def top_gaps(self):
        """The longest idle gaps, summed by what the host launched after
        them (layer and operator): [[label, seconds]]."""
        by_gap = collections.Counter()
        for ns, op in self.gaps:
            label = ('window end' if op is None else
                     f"{op['layer'] or 'outside layers'}: {op['host'] or op['name'][:60]}")
            by_gap[label] += ns / 1e9
        return [[k, v] for k, v in by_gap.most_common(TOP)]


def _ranges(marks):
    """[(start, end, layer)] sorted by start, from the begin and end marks."""
    open_, ranges = {}, []
    for t, name in marks:
        if not name.startswith(MARK):
            continue
        layer, kind = name[len(MARK):].rsplit('/', 1)
        phase, edge = kind.split('.')
        key = (layer, phase)
        if edge == 'begin':
            open_[key] = t
        elif key in open_:
            ranges.append((open_.pop(key), t, layer))
    return sorted(ranges)
