"""Every cell through the harness at a tiny size on the CPU, on the kernels'
plain versions (the look for a chip skipped): the result line has the
contract's keys and the manifest's metric names, the program agrees with the
reference there, and a run with the timed path broken underneath comes out
not correct, once for each fault the cell can have."""
import importlib
import json

import pytest
import torch
from conftest import TINY

from benchmark import run

MANIFEST = json.loads((run.ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in MANIFEST['workloads']]
KINDS = {w['name']: run.cell(w['name'], MANIFEST)[2]['entry'] for w in MANIFEST['workloads']}
CODEC = {w['name'] for w in MANIFEST['workloads']
         if run.cell(w['name'], MANIFEST)[3]['flow']['distribution']['compression'] == 'dcn'}
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']
SECONDS = 0.2
# per-layer metrics that a CPU run can read: the window's, none of the device's
HOST_METRICS = {'dispatch_ms', 'samples_per_s', 'latency_ms_p95'}


def traced(name):
    """Whether a metric reads the device-only trace, which a CPU run has not."""
    reader = importlib.import_module(f'benchmark.metrics.{run.reader_of(name)}')
    return getattr(reader, 'TRACED', False)


def dry_run(cell, trace=0, tamper=None):
    torch.manual_seed(0)
    return run.run(cell, 2 ** 31 + 7, SECONDS, trace, 'cpu', overrides=TINY, tamper=tamper)


@pytest.mark.parametrize('cell', CELLS)
def test_result_line_end_to_end(cell):
    r = dry_run(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == 'checks'
    assert r['correct'] is True and r['failed'] == 0 and r['attempted'] >= 1
    names = [m['name'] for m in run.metrics_of(MANIFEST, 'end_to_end', cell)
             if not traced(m['name'])]
    assert sorted(r['metrics']) == sorted(names)
    assert all(set(v) == {'value', 'unit'} for v in r['metrics'].values())
    assert set(r['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    assert all(set(c) == {'value', 'limit'} for c in r['checks'].values())
    json.dumps(r)


@pytest.mark.parametrize('cell', CELLS)
def test_result_line_per_layer(cell):
    r = dry_run(cell, trace=1)
    assert r['correct'] is True
    names = {m['name'] for m in run.metrics_of(MANIFEST, 'per_layer', cell)}
    assert set(r['metrics']) == {n for n in names if run.reader_of(n) in HOST_METRICS}


def unchanged_state(flow):
    flow.optimizer.step = lambda *args, **kwargs: None


def half_batch(flow):
    if hasattr(flow, 'loss_and_gradients') and flow.optimizer is not None:
        whole = flow.loss_and_gradients

        def half(batch_x, batch_y, *args, **kwargs):
            n = batch_x.shape[0] // 2
            return whole(batch_x[:n], None if batch_y is None else batch_y[:n], *args, **kwargs)
        flow.loss_and_gradients = half
    whole_workflow = flow.run_workflow
    flow.run_workflow = lambda batch_x, augment=False: whole_workflow(
        batch_x[:batch_x.shape[0] // 2], augment)


def answer_altered(flow):
    def alter(module, args, probs):
        return torch.cat([probs[:1].roll(1, dims=1), probs[1:]])
    flow.fan.module.register_forward_hook(alter)


def codeword_altered(flow):
    """One latent value put on the next codeword where the quantizer
    produces it (the decoder's input)."""
    def alter(module, args):
        q = args[0].clone()
        q.view(-1)[q.numel() // 2] += 1.0
        return (q,) + args[1:]
    flow.codec.module.decoder.register_forward_pre_hook(alter)


FAULTS = {'training_step': [unchanged_state, half_batch, answer_altered],
          'run_workflow_to_decisions': [half_batch, answer_altered]}


def faults_of(cell):
    return FAULTS[KINDS[cell]] + ([codeword_altered] if cell in CODEC else [])


@pytest.mark.parametrize('cell,fault', [(c, f) for c in CELLS for f in faults_of(c)],
                         ids=lambda x: getattr(x, '__name__', x))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = dry_run(cell, tamper=fault)
    assert r['correct'] is False, r['checks']
