"""The program's spans against a made-up trace (``spans.py``): device time
goes to the innermost span around the launching operator, a backward
operation to the span of its forward operator by ``sequence_nr``, idle
stretches to the innermost span the host was in or to 'between calls';
and the host→device readers on a made-up context."""
import collections
import time

import pytest
import torch

from benchmark import run, spans, trace
from benchmark.metrics import h2d_copies, h2d_gbps

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


class Event:
    def __init__(self, name, device, start, duration=0, corr=0, linked=0, thread=MAIN, seq=-1,
                 fwd_thread=0, annotation=False):
        self.v = dict(name=name, device=device, start=start, duration=duration, corr=corr,
                      linked=linked, thread=thread, seq=seq, fwd_thread=fwd_thread,
                      annotation=annotation)

    def name(self):
        return self.v['name']

    def device_type(self):
        return self.v['device']

    def start_ns(self):
        return self.v['start']

    def duration_ns(self):
        return self.v['duration']

    def correlation_id(self):
        return self.v['corr']

    def linked_correlation_id(self):
        return self.v['linked']

    def start_thread_id(self):
        return self.v['thread']

    def sequence_nr(self):
        return self.v['seq']

    def fwd_thread_id(self):
        return self.v['fwd_thread']

    def is_user_annotation(self):
        return self.v['annotation']


def span(name, start, end):
    return Event(name, CPU, start, end - start, annotation=True)


def made_up_step():
    """A step: 'manipulations' launches a conv (sequence 7, seen first by a
    view in 'step' that makes no node), 'fan' a matmul (sequence 8); the
    backward runs on the autograd thread inside 'backward': the matmul's
    backward, the conv's backward, then a gradient accumulation that no
    forward operator owns; an add launched outside every span."""
    return [
        span('step', 0, 1000), span('manipulations', 100, 200), span('fan', 300, 400),
        span('backward', 500, 900),
        Event('aten::permute', CPU, 50, 5, corr=10, seq=7),
        Event('aten::conv2d', CPU, 120, 10, corr=1, seq=7),
        Event('aten::mm', CPU, 320, 10, corr=2, seq=8),
        Event('autograd::engine::evaluate_function: MmBackward0', CPU, 510, 100, corr=3,
              thread=AUTOGRAD, seq=8, fwd_thread=MAIN),
        Event('aten::mm', CPU, 520, 10, corr=4, thread=AUTOGRAD),
        Event('autograd::engine::evaluate_function: ConvolutionBackward0', CPU, 620, 100,
              corr=5, thread=AUTOGRAD, seq=7, fwd_thread=MAIN),
        Event('aten::convolution_backward', CPU, 630, 10, corr=6, thread=AUTOGRAD),
        Event('autograd::engine::evaluate_function: AccumulateGrad', CPU, 800, 50, corr=7,
              thread=AUTOGRAD),
        Event('aten::add_', CPU, 810, 5, corr=8, thread=AUTOGRAD),
        Event('aten::add', CPU, 1100, 5, corr=9),
        # device operations and the annotations' device mirrors, left out
        Event('conv_kernel', CUDA, 150, 300, linked=1), Event('gemm', CUDA, 450, 200, linked=2),
        Event('gemm_dgrad', CUDA, 650, 100, linked=4),
        Event('conv_dgrad', CUDA, 750, 400, linked=6),
        Event('add_kernel', CUDA, 1150, 20, linked=8), Event('add', CUDA, 1200, 10, linked=9),
        Event('fan', CUDA, 450, 200, annotation=True),
    ]


def test_device_time_goes_to_the_spans_and_backward_to_its_forward():
    ops = spans.attribute(made_up_step())
    ns = collections.Counter()
    for _, duration, span_name, _ in ops:
        ns[span_name] += duration
    assert ns == {'manipulations': 300 + 400, 'fan': 200 + 100, 'backward': 20,
                  spans.OUTSIDE: 10}
    assert ('conv_dgrad', 'aten::convolution_backward') in {(d, h) for d, _, _, h in ops}


def test_idle_goes_to_the_innermost_span_and_between_calls():
    # device busy 100-300 and 700-800 in a window 0-1000
    events = [Event('k', CUDA, 100, 200), Event('k', CUDA, 700, 100)]
    timeline = trace.Trace(events + [Event(trace.WINDOW_BEGIN, CPU, 0),
                                     Event(trace.WINDOW_END, CPU, 1000)], n_calls=1)
    records = [{'name': 'step', 'start': 50, 'end': 900},
               {'name': 'input', 'start': 60, 'end': 80},
               {'name': 'optimizer', 'start': 350, 'end': 650}]
    idle = spans.idle_by_span(timeline, records)
    assert idle['between calls'] == pytest.approx((50 + 100) / 1e9)
    assert idle['input'] == pytest.approx(20 / 1e9)
    assert idle['step'] == pytest.approx((30 + 50 + 50 + 100) / 1e9)
    assert idle['optimizer'] == pytest.approx(300 / 1e9)
    assert sum(idle.values()) == pytest.approx(timeline.window_s - timeline.busy_s)


def test_htod_operations_a_call():
    events = [Event('Memcpy HtoD (Pageable -> Device)', CUDA, 0, 500),
              Event('k', CUDA, 600, 100), Event('Memcpy HtoD (Pageable -> Device)', CUDA, 800, 300)]
    assert spans.htod_per_call(trace.Trace(events, n_calls=2)) == (1.0, pytest.approx(400e-9))


def test_the_h2d_readers_on_a_made_up_context(monkeypatch):
    events = [Event('Memcpy HtoD (Pageable -> Device)', CUDA, 0, 1000), Event('k', CUDA, 1000, 10),
              Event('Memcpy HtoD (Pageable -> Device)', CUDA, 1100, 200)]
    host = trace.Trace([Event(trace.WINDOW_BEGIN, CPU, 5), Event(trace.WINDOW_END, CPU, 50)], 2)
    ctx = run.Context(timeline=trace.Trace(events, n_calls=2), trace=host)
    windows = []

    def calls(begin, end):
        windows.append((begin, end))
        return [(1, 4000), (1, 4000), (3, 6000)]
    monkeypatch.setattr(spans, 'program_calls', calls)
    assert h2d_copies.read(ctx) == 1.0                   # the device's count, not the program's
    # 14000 / 3 bytes a call over 600 ns a call
    assert h2d_gbps.read(ctx) == pytest.approx(14000 / 3 / 600e-9 / 1e9)
    assert windows == [(5, 50)]                          # the host-and-device run's calls
    assert h2d_copies.read(run.Context()) is None        # no device traced
    assert h2d_gbps.read(run.Context()) is None
    monkeypatch.setattr(spans, 'program_calls', lambda begin, end: [])
    assert h2d_copies.read(ctx) == 1.0 and h2d_gbps.read(ctx) is None


def test_program_calls_sums_each_root_span_in_the_window():
    from neural_imaging_tpu_torch.utils import profiling
    profiling.clear()
    profiling.tracing(True)
    try:
        with profiling.span('request'):                  # before the window
            profiling.to_device([1.0], 'meta')
        begin = time.time_ns()
        with profiling.span('step'):
            with profiling.span('input'):
                profiling.to_device([1.0, 2.0], 'meta')
            profiling.to_device([1.0], 'meta')
        with profiling.span('channel'):                  # a root of no call
            profiling.to_device([1.0], 'meta')
        assert spans.program_calls(begin, time.time_ns()) == [(2, 12)]
    finally:
        profiling.tracing(False)
        profiling.clear()


CELLS = [w['name'] for w in run.load_json(run.ROOT / 'BENCHMARK.json')['workloads']]


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_every_htod_copy_is_counted(cell, cuda, monkeypatch):
    """A traced run of the cell: the host→device copies the program counted
    (``profiling.to_device`` in its spans) equal the 'Memcpy HtoD'
    operations of the device-only trace, so that no upload site of the call
    path goes round the helper. The profiler at times loses a copy's device
    record (a runtime 'cudaMemcpy*' call with no 'Memcpy' record): the
    trace's count may fall short of the program's by those lost records."""
    memcpys = []        # (runtime calls, device records) of each traced run
    make = trace.Trace.__init__

    def counting(self, events, n_calls):
        events = list(events)
        memcpys.append((
            sum(e.device_type() == CPU and e.name().startswith('cudaMemcpy') for e in events),
            sum(e.device_type() == CUDA and e.name().startswith('Memcpy') for e in events)))
        make(self, events, n_calls)
    monkeypatch.setattr(trace.Trace, '__init__', counting)
    keep = {}
    run.run(cell, 2 ** 31 + 23, 1.0, 1, 'cuda', keep=keep)
    ctx = keep['ctx']
    program = spans.program_calls(ctx.trace.begin, ctx.trace.end)
    assert len(program) == ctx.timeline.n_calls, 'the program recorded other calls'
    counted = sum(copies for copies, _ in program)
    traced = round(spans.htod_per_call(ctx.timeline)[0] * ctx.timeline.n_calls)
    calls, records = memcpys[0]                          # the device-only run
    assert counted - (calls - records) <= traced <= counted, (counted, traced, calls, records)
