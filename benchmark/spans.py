"""
The program's own spans and counters (``neural_imaging_tpu_torch.utils.profiling``)
set against a profiler trace: what the per-layer readers of the spans and
the span report (``tools/span_report.py``) compute.

Spans. The program opens a span at each stage of a step or a request
(``SPANS``); while a ``torch.profiler`` session runs, each is recorded in
memory (``profiling.spans()``, nanoseconds on the profiler's clock) and is a
``record_function`` event of the trace.

Device time by span, from a trace of the host and the device: a device
operation belongs to the innermost span that encloses the start of the host
operator that launched it. An operator of the backward pass belongs to the
span of the forward operator that made the autograd node it evaluates
(the profiler's ``sequence_nr`` of the enclosing ``evaluate_function``
event, and its forward thread), so a stage's backward counts with its
forward;
what no forward operator owns (gradient accumulation) stays in the span the
host was in ('backward').

Idle by span, from a trace of the device alone and the spans recorded
beside it: each stretch of a gap between device operations goes to the
innermost span the host was in during it, or to 'between calls' outside
every root span. The stretches sum to the window's idle time.
"""
import bisect
import collections
import itertools

import torch

# the program's spans: roots first (see utils/profiling.py and the flow)
ROOTS = ('step', 'request')
SPANS = ROOTS + ('input', 'isp', 'manipulations', 'channel', 'fan', 'loss', 'backward',
                 'optimizer', 'readback', 'build', 'kernels.load')
BETWEEN = 'between calls'
OUTSIDE = 'outside spans'
HTOD = 'Memcpy HtoD'


def program_calls(begin, end):
    """[(copies, bytes)] of host→device copies counted inside each call (a
    root span 'step' or 'request' and the spans under it) that the program
    recorded between ``begin`` and ``end`` (ns), or [] where the program
    records no spans."""
    try:
        from neural_imaging_tpu_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, 'spans', lambda: [])()
    roots = {r['id'] for r in records if r['parent'] is None and r['name'] in ROOTS
             and begin <= r['start'] and r['end'] is not None and r['end'] <= end}
    calls = collections.defaultdict(lambda: [0, 0])
    for r in records:
        if r['call'] in roots:
            calls[r['call']][0] += r['h2d_copies']
            calls[r['call']][1] += r['h2d_bytes']
    return [tuple(calls[c]) for c in sorted(calls)]


class Innermost:
    """The innermost of nested intervals [(start, end, name)] (one thread's
    spans) at a moment."""

    def __init__(self, intervals):
        self.intervals = sorted(intervals)
        self.starts = [i[0] for i in self.intervals]
        # the latest end among the intervals up to each: where a look back stops
        self.reach = list(itertools.accumulate((i[1] for i in self.intervals), max))
        self.cuts = sorted({t for i in self.intervals for t in i[:2]})

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            start, end, name = self.intervals[i]
            if end >= t:
                return name
            i -= 1
        return None

    def segments(self, begin, end):
        """[(a, b, innermost name or None)] covering [begin, end)."""
        inside = self.cuts[bisect.bisect_right(self.cuts, begin):
                           bisect.bisect_left(self.cuts, end)]
        cuts = [begin] + inside + [end]
        return [(a, b, self.at((a + b) / 2)) for a, b in zip(cuts, cuts[1:])]


def _ns(event, what):
    return getattr(event, f'{what}_ns')()


def _is_span(event):
    return event.name() in SPANS and event.device_type() == torch.autograd.DeviceType.CPU


def attribute(events):
    """[(device operation's name, its ns, its span or OUTSIDE, the launching
    host operator's name or None)] of a host-and-device trace, by the
    attribution in the module docstring."""
    cpu, device, spans = [], [], collections.defaultdict(list)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if _is_span(e):
                spans[e.start_thread_id()].append(
                    (_ns(e, 'start'), _ns(e, 'start') + _ns(e, 'duration'), e.name()))
            elif (e.linked_correlation_id() == 0
                  and not getattr(e, 'is_user_annotation', lambda: False)()):
                cpu.append(e)           # the operators (runtime calls link to the device)
        elif not (getattr(e, 'is_user_annotation', lambda: False)() or e.name() in SPANS
                  or e.name().startswith(('bench.', 'ProfilerStep', 'Optimizer.'))):
            device.append(e)
    by_thread = {tid: Innermost(iv) for tid, iv in spans.items()}
    everywhere = Innermost([i for iv in spans.values() for i in iv])

    def span_at(tid, t):
        inner = by_thread.get(tid)
        name = inner.at(t) if inner is not None else None
        return name if name is not None else everywhere.at(t)
    # forward operators by (thread, sequence_nr): the last one's start. An
    # operator that makes no autograd node (a view of a tensor that needs no
    # gradient) sees the number of the next node made, so the last operator
    # to see a number is the one that made its node.
    forward = {}
    # backward function events of each thread: (start, end, forward key)
    backward = collections.defaultdict(list)
    host = {}
    for e in cpu:
        start, tid, seq = _ns(e, 'start'), e.start_thread_id(), e.sequence_nr()
        if e.fwd_thread_id() > 0 and seq >= 0:
            backward[tid].append((start, start + _ns(e, 'duration'), (e.fwd_thread_id(), seq)))
        elif seq >= 0:
            key = (tid, seq)
            forward[key] = max(forward.get(key, start), start)
        host[e.correlation_id()] = e
    owners = {tid: Innermost(iv) for tid, iv in backward.items()}
    out = []
    for d in device:
        launch = host.get(d.linked_correlation_id())
        name = None
        if launch is not None:
            tid, start = launch.start_thread_id(), _ns(launch, 'start')
            owner = owners[tid].at(start) if tid in owners else None
            if owner is not None and owner in forward:
                name = span_at(owner[0], forward[owner])
            if name is None:
                name = span_at(tid, start)
        out.append((d.name(), _ns(d, 'duration'), name or OUTSIDE,
                    None if launch is None else launch.name()))
    return out


def idle_by_span(timeline, records):
    """{span name or BETWEEN: idle seconds} of a device-only ``trace.Trace``
    with the spans ``records`` (``profiling.spans()``) recorded beside it."""
    inner = Innermost([(r['start'], r['end'], r['name']) for r in records
                       if r['end'] is not None])
    idle = collections.Counter()
    for ns, op in timeline.gaps:
        end = timeline.end if op is None else op['start']
        for a, b, name in inner.segments(end - ns, end):
            idle[name or BETWEEN] += (b - a) / 1e9
    return dict(idle)


def htod_per_call(timeline):
    """(operations, seconds) a call of the device's host→device copies."""
    ops = [op for op in timeline.ops if op['name'].startswith(HTOD)]
    return (len(ops) / timeline.n_calls,
            sum(op['end'] - op['start'] for op in ops) / 1e9 / timeline.n_calls)
