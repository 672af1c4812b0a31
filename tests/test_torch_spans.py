"""The port's spans (``utils/profiling.py``) on the CPU: the recorder off
and on, its ids and per-thread stacks, its clock against
``torch.profiler``'s, the host→device helper and the copies it counts, a
trainable JPEG channel's tables of its own, and the spans that the joint
flow opens in a training step, a scanned step, a request and, with a
learned codec, around the codec."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neural_imaging_tpu_torch.models import jpeg as jpeg_models
from neural_imaging_tpu_torch.utils import profiling
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    ManipulationClassification)

torch.set_num_threads(1)

PATCH = 16
FAN_ARGS = {'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}
STAGES = {'input', 'isp', 'manipulations', 'channel', 'fan', 'loss', 'backward', 'optimizer'}


@pytest.fixture
def recording():
    profiling.clear()
    profiling.tracing(True)
    yield
    profiling.tracing(False)
    profiling.clear()


def tree(records):
    """{root id: [its name, the names of its children]}."""
    names = {r['id']: r['name'] for r in records}
    out = {}
    for r in records:
        if r['parent'] is None:
            out.setdefault(r['id'], [r['name'], []])
        else:
            out.setdefault(r['parent'], [names[r['parent']], []])[1].append(r['name'])
    return out


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, 'record_function', lambda name: opened.append(name))
    profiling.clear()
    a, b = profiling.span('step'), profiling.span('isp')
    assert a is b                               # one shared object
    with a, profiling.root('request'):
        profiling.to_device(np.ones(3), 'cpu')
    assert profiling.spans() == [] and opened == []


def test_nesting_parent_and_call_ids(recording):
    with profiling.span('step'):
        with profiling.span('isp'):
            pass
        with profiling.span('loss'):
            with profiling.span('fan'):
                pass
    with profiling.span('step'):
        pass
    step, isp, loss, fan, step2 = profiling.spans()
    assert [r['name'] for r in (step, isp, loss, fan, step2)] == [
        'step', 'isp', 'loss', 'fan', 'step']
    assert step['parent'] is None and step['call'] == step['id']
    assert isp['parent'] == loss['parent'] == step['id'] and fan['parent'] == loss['id']
    assert {isp['call'], loss['call'], fan['call']} == {step['id']}
    assert step2['call'] == step2['id'] != step['id']
    assert step['start'] <= isp['start'] <= isp['end'] <= loss['start'] <= fan['end'] <= step[
        'end'] <= step2['start']


def test_root_opens_only_where_no_span_is_open(recording):
    with profiling.root('request'):
        with profiling.root('request'):
            with profiling.span('input'):
                pass
    assert [(r['name'], r['parent'] is None) for r in profiling.spans()] == [
        ('request', True), ('input', False)]


def test_each_thread_has_its_own_stack(recording):
    inside, release = threading.Event(), threading.Event()

    def other():
        with profiling.span('request'):
            inside.set()
            release.wait(5)

    worker = threading.Thread(target=other)
    with profiling.span('step'):
        worker.start()
        inside.wait(5)
        with profiling.span('isp'):
            pass
        release.set()
        worker.join()
    by_name = {r['name']: r for r in profiling.spans()}
    assert by_name['request']['parent'] is None
    assert by_name['isp']['parent'] == by_name['step']['id']


def test_clear_drops_the_records(recording):
    with profiling.span('step'):
        pass
    assert len(profiling.spans()) == 1
    profiling.clear()
    assert profiling.spans() == []


def test_span_times_are_on_the_profilers_clock():
    """A span recorded in memory holds its own ``record_function`` event of a
    CPU profiler session, each end within what opening or closing that
    function takes (tens of microseconds on a slow host): one clock."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with profiling.span('fan'):
                time.sleep(1e-3)
    events = sorted(_ns(e) for e in prof.profiler.kineto_results.events() if e.name() == 'fan')
    records = [(r['start'], r['end']) for r in profiling.spans()]
    profiling.clear()
    assert len(events) == len(records) == 5
    assert all(a <= c <= d <= b for (a, b), (c, d) in zip(records, events))
    gaps = [max(c - a, b - d) for (a, b), (c, d) in zip(records, events)]
    assert min(gaps) < 50_000, gaps                  # ns


def _ns(event):
    return event.start_ns(), event.start_ns() + event.duration_ns()


def test_a_profiler_session_records_spans():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('channel'):
            torch.ones(4) + 1
    assert [r['name'] for r in profiling.spans()] == ['channel']
    assert 'channel' in {e.name() for e in prof.profiler.kineto_results.events()}
    profiling.clear()
    with profiling.span('channel'):
        pass
    assert profiling.spans() == []


def test_to_device_counts_copies_to_a_device_in_the_open_span(recording):
    host = torch.arange(6, dtype=torch.float32)
    with profiling.span('input'):
        assert profiling.to_device(host, 'cpu') is host
        assert profiling.to_device(np.ones((2, 3), np.uint8), 'cpu', torch.float32).dtype == (
            torch.float32)
        out = profiling.to_device(np.ones((2, 3), np.uint16), 'meta', torch.float32)
        profiling.to_device(out, 'meta')                   # already there: no copy
    profiling.to_device(np.ones(2), 'meta')                # no span open: counted nowhere
    assert out.device.type == 'meta' and out.dtype == torch.float32
    (record,) = profiling.spans()
    assert (record['h2d_copies'], record['h2d_bytes']) == (1, 24)


def test_a_trainable_jpeg_channel_has_two_tables_of_its_own():
    channel = jpeg_models.DifferentiableJPEG(None, trainable=True, device='cpu')
    luma, chroma = channel.params['q_mtx_luma'], channel.params['q_mtx_chroma']
    assert luma.data_ptr() != chroma.data_ptr()
    optimizer = torch.optim.Adam([luma], lr=0.1)
    luma.sum().backward()
    optimizer.step()
    assert torch.all(luma < 1) and torch.equal(chroma, torch.ones(8, 8))


@pytest.fixture(scope='module')
def flow():
    return ManipulationClassification('INet', raw_patch_size=PATCH, trainable={'nip'},
                                      fan_args=FAN_ARGS, device='cpu')


@pytest.fixture(scope='module')
def batches():
    rng = np.random.default_rng(5)
    return (rng.random((2, PATCH, PATCH, 4), dtype=np.float32),
            rng.random((2, 2 * PATCH, 2 * PATCH, 3), dtype=np.float32))


def test_construction_is_a_build_span(recording):
    ManipulationClassification('INet', raw_patch_size=PATCH, fan_args=FAN_ARGS, device='cpu')
    roots = [r for r in profiling.spans() if r['parent'] is None]
    assert [r['name'] for r in roots] == ['build']


def test_a_training_step_is_one_call_of_every_stage(flow, batches, recording):
    flow.training_step(*batches, lambda_nip=0.1)
    flow.training_step(*batches, lambda_nip=0.1)
    records = profiling.spans()
    trees = list(tree(records).values())
    assert [name for name, _ in trees] == ['step', 'step']
    for _, children in trees:
        assert set(children) == STAGES and children.count('input') == 2
    calls = {r['call'] for r in records}
    assert len(calls) == 2
    assert all(r['end'] >= r['start'] for r in records)


def test_a_scanned_step_is_a_step(flow, batches, recording):
    class Sampler:
        _loaded = 'x'

        def __call__(self, step):
            return torch.from_numpy(batches[0])

    flow.training_scan(Sampler(), 2)
    trees = list(tree(profiling.spans()).values())
    assert [name for name, _ in trees] == ['step', 'step']
    assert set(trees[0][1]) == STAGES and trees[0][1].count('input') == 1


def test_a_request_reads_back_inside_its_root(flow, batches, recording):
    flow.run_workflow_to_decisions(batches[0])
    flow.run_workflow(batches[0])
    trees = list(tree(profiling.spans()).values())
    assert trees == [['request', ['input', 'isp', 'manipulations', 'channel', 'fan',
                                  'readback']],
                     ['request', ['input', 'isp', 'manipulations', 'channel', 'fan']]]


def test_a_cpu_call_copies_nothing_to_a_device(flow, batches, recording):
    flow.training_step(*batches, lambda_nip=0.1)
    flow.run_workflow_to_decisions(batches[0], augment=True)
    records = profiling.spans()
    assert records and all(r['h2d_copies'] == r['h2d_bytes'] == 0 for r in records)


def test_the_channel_encloses_the_learned_codec(recording):
    dcn = ManipulationClassification(
        'ONet', manipulations=['sharpen:1'], fan_args=FAN_ARGS, raw_patch_size=PATCH,
        distribution={'downsampling': 'none', 'compression': 'dcn',
                      'compression_params': {'dirname': '32c'}},
        trainable={'dcn'}, device='cpu')
    moments = []
    hooks = [dcn.codec.module.encoder.register_forward_pre_hook(
                 lambda m, a: moments.append(time.time_ns())),
             dcn.codec.module.decoder.register_forward_hook(
                 lambda m, a, o: moments.append(time.time_ns()))]
    profiling.clear()
    x = np.random.default_rng(2).random((2, 2 * PATCH, 2 * PATCH, 3), dtype=np.float32)
    dcn.training_step(x, None, lambda_dcn=0.1)
    for h in hooks:
        h.remove()
    (channel,) = [r for r in profiling.spans() if r['name'] == 'channel']
    assert len(moments) == 2
    assert channel['start'] <= moments[0] <= moments[1] <= channel['end']
    assert list(tree(profiling.spans()).values())[0][0] == 'step'
