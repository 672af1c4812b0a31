"""The reduction of a profiler trace, on a made-up one: the window between
its marks, busy time as the union of device intervals, idle gaps labelled by
the operator launched after them, and device time attributed to the layer
whose marks enclose the launching operator."""
import pytest
import torch

from benchmark import run, trace
from benchmark.metrics import device_idle_pct, device_ms_per_sample, fan_ms, nip_ms, step_mfu

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, duration=0, corr=0, linked=0):
        self._v = (name, device, start, duration, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def made_up_trace():
    m = trace.MARK
    return [
        Event(trace.WINDOW_BEGIN, CPU, 0),
        Event(m + 'nip/fwd.begin', CPU, 100), Event('aten::conv', CPU, 150, 10, corr=1),
        Event(m + 'nip/fwd.end', CPU, 200),
        Event(m + 'fan/fwd.begin', CPU, 300), Event('aten::mm', CPU, 350, 10, corr=2),
        Event(m + 'fan/fwd.end', CPU, 400), Event('aten::add', CPU, 500, 10, corr=3),
        Event(trace.WINDOW_END, CPU, 2000),
        # device: conv 200-600, mm 500-900 (overlapping), add 1500-1600
        Event('conv_kernel', CUDA, 200, 400, linked=1), Event('gemm', CUDA, 500, 400, linked=2),
        Event('add_kernel', CUDA, 1500, 100, linked=3),
    ]


def test_window_union_gaps_and_layers():
    t = trace.Trace(made_up_trace(), n_calls=2)
    assert t.window_s == pytest.approx(2000e-9)
    assert t.busy_s == pytest.approx(800e-9)              # 200-900 and 1500-1600
    assert t.layer_ms('nip') == pytest.approx(400e-6 / 2)
    assert t.layer_ms('fan') == pytest.approx(400e-6 / 2)
    assert t.layer_ms('codec') is None
    gaps = dict(t.top_gaps())
    assert gaps['nip: aten::conv'] == pytest.approx(200e-9)
    assert gaps['outside layers: aten::add'] == pytest.approx(600e-9)
    assert gaps['window end'] == pytest.approx(400e-9)
    assert [name for name, _ in t.top_ops()] == ['conv_kernel', 'gemm', 'add_kernel']


def test_readers_on_the_made_up_trace():
    t = trace.Trace(made_up_trace(), n_calls=2)
    ctx = run.Context(trace=t, timeline=t, reference_flops=1e3,
                      peaks={'bf16_flops': 1e15}, samples=4)
    assert device_idle_pct.read(ctx) == pytest.approx(60.0)
    assert device_ms_per_sample.read(ctx) == pytest.approx(1e3 * 800e-9 / (2 * 4))
    assert nip_ms.read(ctx) == pytest.approx(2e-4) and fan_ms.read(ctx) == pytest.approx(2e-4)
    assert step_mfu.read(ctx) == pytest.approx(100 * 1e3 * 2 / 2000e-9 / 1e15)


def test_a_device_only_trace_runs_from_first_to_last_operation():
    events = [e for e in made_up_trace() if e.device_type() == CUDA]
    t = trace.Trace(events, n_calls=1)
    assert t.window_s == pytest.approx(1400e-9) and t.busy_s == pytest.approx(800e-9)
