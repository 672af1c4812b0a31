"""The port's end-to-end framework harness (``cli/test_framework.py``) and
its batch scripts, on the CPU, against the JAX package's harness
(``test_framework.py``) and ``config/tests/framework.json``.

The cut runs. Every scenario runs end to end through the harness, each CLI
in its own process as the harness runs it, on a spec derived here with the
epochs cut to 2 and validation at every epoch. They check that every
artifact the real spec lists is written and that every gate key is logged
and finite; they do not check the gates, which only a full-length run can
meet (the ``slow``/``e2e`` test at the end runs the whole spec, as
``tests/test_e2e.py`` does for the JAX package).

``train-nip`` cut to 3 epochs runs through both harnesses on the same
fixture data: INet starts from the same fixed weights in both packages and
both draw the same host batches, so the last validation PSNR agrees within
``PSNR_ATOL`` dB, the tolerance ``tests/test_torch_nip_trainer.py`` holds
the two NIP trainers to."""
import copy
import importlib
import json
import math
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_imaging_tpu.utils import utils as jutils
from neural_imaging_tpu_torch.cli import test_framework as harness
from neural_imaging_tpu_torch.data import png
from neural_imaging_tpu_torch.utils import jsonlog
from neural_imaging_tpu_torch.utils.utils import get

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import test_framework as jax_harness  # noqa: E402  (the JAX package's harness)

torch.set_num_threads(1)

SPEC = harness.load_spec()
SCENARIOS = list(SPEC)
CAM = harness.DEFAULT_CAM
CUT_EPOCHS, PARITY_EPOCHS = 2, 3
PSNR_ATOL = 1e-3
# the CLIs' processes, one thread each as the tests' own
ONE_THREAD = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1', 'JAX_PLATFORMS': 'cpu'}


def derive(spec, epochs=CUT_EPOCHS, thresholds=None):
    """A copy of ``spec`` with ``--epochs`` cut, validation at every epoch
    and, where given, every gate's threshold replaced."""
    spec = copy.deepcopy(spec)
    for scenario in spec.values():
        command = re.sub(r'--epochs \d+', f'--epochs {epochs}', scenario['command'])
        scenario['command'] = re.sub(r'--val-schedule \d+', '--val-schedule 1', command)
        if thresholds is not None:
            values = scenario['performance']['values']
            scenario['performance']['values'] = {k: thresholds for k in values}
    return spec


@pytest.fixture(scope='module')
def one_thread():
    saved = {k: os.environ.get(k) for k in ONE_THREAD}
    os.environ.update(ONE_THREAD)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('framework'))
    harness.prepare_data(root, CAM)
    return root


@pytest.fixture(scope='module')
def cut_run(data_root, one_thread):
    """All seven scenarios cut, in the spec's order, through the harness;
    thresholds lowered so that no scenario's dependents are skipped."""
    return harness.run_all(derive(SPEC, thresholds=-math.inf), data_root, CAM, device='cpu')


# (a) the spec's commands map onto the port's CLIs

@pytest.mark.parametrize('name', SCENARIOS)
def test_scenario_maps_to_a_port_cli_that_parses_it(name):
    module, argv = harness.port_command(SPEC[name]['command'], '/r', CAM, 'cpu')
    tokens = shlex.split(SPEC[name]['command'].format(root='/r', cam=CAM, repo=ROOT))
    script = os.path.basename(tokens[1])[:-3]
    assert module == f'neural_imaging_tpu_torch.cli.{script}'
    assert argv == tokens[2:] + ['--device', 'cpu']         # the flags pass unchanged
    args = importlib.import_module(module).build_parser().parse_args(argv)
    assert args.device == 'cpu'
    if '--epochs' in argv:
        assert args.epochs == int(argv[argv.index('--epochs') + 1])


@pytest.mark.parametrize('command', [
    'python3 {repo}/bench.py --epochs 2',
    'python3 {repo}/no_such_script.py',
    'bash {repo}/train_manipulation_batch.sh',
    'python3 -c print(1)'])
def test_a_command_without_a_port_cli_raises(command, tmp_path):
    with pytest.raises(ValueError, match='no port CLI|not a Python script'):
        harness.port_command(command, '/r', CAM, 'cpu')
    spec = {'train-nip': SPEC['train-nip'], 'other': {'command': command}}
    with pytest.raises(ValueError):       # before anything runs
        harness.run_all(spec, str(tmp_path), CAM, device='cpu',
                        run=lambda *a: pytest.fail('ran a scenario'))


def test_harness_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        harness.main(['--root', str(tmp_path), '--scenario', 'train-nip'])
    assert not os.listdir(tmp_path)


# (b) the key-path lookup the gates read

LOG = {'performance': {'psnr': {'validation': [30.0, 41.5]}, 'loss': 0.1},
       'forensics': {'performance': {'accuracy': {'validation': [0.25, 0.75]}}},
       'list': [{'a': 1}]}


@pytest.mark.parametrize('path, sep', [
    ('performance/psnr/validation', '/'), ('performance/loss', '/'),
    ('forensics/performance/accuracy/validation', '/'), ('/performance//psnr/', '/'),
    ('performance.psnr', '.'), ('list', '/'), ('', '/')])
def test_get_agrees_with_the_jax_get(path, sep):
    assert get(LOG, path, sep) == jutils.get(LOG, path, sep)


@pytest.mark.parametrize('path, error', [
    ('performance/ssim/validation', KeyError), ('missing', KeyError),
    ('list/0', TypeError), ('performance/loss/x', TypeError)])
def test_get_fails_as_the_jax_get(path, error):
    with pytest.raises(error):
        jutils.get(LOG, path)
    with pytest.raises(error):
        get(LOG, path)


# (c) the fixture data

@pytest.mark.parametrize('subdir', [CAM, 'rgb'])
def test_fixture_directories_match_the_jax_harness(subdir, data_root, tmp_path):
    jax_harness.prepare_data(str(tmp_path), CAM)
    port_dir, jax_dir = os.path.join(data_root, 'data', subdir), str(tmp_path / 'data' / subdir)
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert len([n for n in names if n.endswith('.png')]) == (8 if subdir == CAM else 18)
    assert len([n for n in names if n.endswith('.npy')]) == (8 if subdir == CAM else 0)
    for name in names:
        a, b = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith('.npy'):
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype == np.uint16 and x.shape == (96, 128, 4)
        else:
            x, y = png.read_png(a), png.read_png(b)
            assert x.shape == (192, 256, 3)
        np.testing.assert_array_equal(x, y)


# (d) every scenario end to end, cut

@pytest.mark.parametrize('name', SCENARIOS)
def test_cut_scenario_writes_every_artifact_and_logs_its_gates(name, cut_run, data_root):
    result = cut_run[name]
    assert result['status'] == 'PASS', result['message']
    assert harness.missing_artifacts(SPEC[name], data_root, CAM) == []
    gates = harness.gate_values(SPEC[name], data_root, CAM)
    assert gates.keys() == SPEC[name]['performance']['values'].keys()
    for key, (value, threshold) in gates.items():
        assert threshold == SPEC[name]['performance']['values'][key]
        assert np.isfinite(value), (key, value)
    assert result['gates'].keys() == gates.keys() and result['seconds'] > 0


# (e) a failing gate, a failing command and the skips that follow

@pytest.mark.parametrize('failure', ['gate', 'command'])
def test_a_failure_reports_fail_skips_its_dependents_and_exits_1(failure, cut_run, data_root,
                                                                 tmp_path, capsys):
    spec = derive({k: SPEC[k] for k in ('train-nip', 'resume-nip', 'train-manipulation')})
    if failure == 'gate':
        spec['train-nip']['performance']['values'] = {'performance/psnr/validation': 1e9}
    else:
        # a batch of 4 from 2 training images: the CLI refuses and exits 1
        spec['train-nip']['command'] = spec['train-nip']['command'].replace('6:2:2', '2:2:2')
    path = tmp_path / 'spec.json'
    path.write_text(json.dumps(spec))
    with pytest.raises(SystemExit) as exit_:
        harness.main(['--spec', str(path), '--root', data_root, '--device', 'cpu'])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    summary = {name: status for status, name in re.findall(r'^(PASS|FAIL|SKIP)\s+(\S+)', out,
                                                           re.M)}
    assert summary == {'train-nip': 'FAIL', 'resume-nip': 'SKIP', 'train-manipulation': 'SKIP'}
    reason = 'performance/psnr/validation = ' if failure == 'gate' else 'command exited with'
    assert f'--- train-nip: FAIL ({reason}' in out
    assert '--- resume-nip: SKIP (prerequisite did not pass: train-nip)' in out


def test_all_passing_exits_0(cut_run, data_root, tmp_path, capsys):
    spec = derive({'train-classic-isp': SPEC['train-classic-isp']}, thresholds=0)
    path = tmp_path / 'spec.json'
    path.write_text(json.dumps(spec))
    with pytest.raises(SystemExit) as exit_:
        harness.main(['--spec', str(path), '--root', data_root, '--device', 'cpu'])
    assert exit_.value.code == 0
    assert re.search(r'^PASS\s+train-classic-isp\s+[\d.]+ s\s+ok$', capsys.readouterr().out, re.M)


# (f) train-nip through both harnesses

def test_train_nip_matches_the_jax_harness(tmp_path, one_thread):
    spec = derive({'train-nip': SPEC['train-nip']}, epochs=PARITY_EPOCHS)['train-nip']
    roots = {}
    for package in ('jax', 'port'):
        roots[package] = str(tmp_path / package)
        os.makedirs(roots[package])
    jax_harness.prepare_data(roots['jax'], CAM)
    harness.prepare_data(roots['port'], CAM)
    ok, message = jax_harness.run_scenario('train-nip', spec, roots['jax'], CAM, platform='cpu')
    assert ok, message
    ok, message, gates = harness.run_scenario('train-nip', spec, roots['port'], CAM, 'cpu')
    assert ok, message
    logs = {package: jsonlog.load_json(os.path.join(
        root, spec['performance']['file'].format(cam=CAM))) for package, root in roots.items()}
    ref, port = logs['jax'], logs['port']
    assert port.keys() == ref.keys()
    assert port['performance'].keys() == ref['performance'].keys()
    for metric, scopes in ref['performance'].items():
        assert port['performance'][metric].keys() == scopes.keys()
        for scope, values in scopes.items():
            assert len(port['performance'][metric][scope]) == len(values) > 0, (metric, scope)
    key = 'performance/psnr/validation'
    assert len(get(port, key)) == PARITY_EPOCHS
    np.testing.assert_allclose(get(port, key)[-1], jutils.get(ref, key)[-1], atol=PSNR_ATOL)
    assert gates[key][0] == get(port, key)[-1]


# the port's batch scripts, cut, on a tiny fixture

BATCH_DATA = dict(n_images=6, height=64, width=96, seed=500)


@pytest.fixture(scope='module')
def batch_runs(tmp_path_factory, one_thread):
    from neural_imaging_tpu_torch.data import fixtures
    work = tmp_path_factory.mktemp('batch')
    fixtures.make_dataset(str(work / 'data'), **BATCH_DATA)
    env = {**os.environ, 'PYTHON': sys.executable, 'NIPS': 'INet', 'LNS': '0.05 0.1',
           'EPOCHS': '2'}
    proc = subprocess.run(
        [os.path.join(ROOT, 'neural_imaging_tpu_torch/cli/train_manipulation_batch.sh'),
         '--data', 'data', '--split', '4:2:2', '--patch', '16', '--batch', '2',
         '--val-schedule', '1', '--dir', 'm', '--nip-dir', os.path.join(ROOT, 'data/models/nip'),
         '--fan', "{'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}", '--device', 'cpu'],
        cwd=work, env=env, capture_output=True, text=True, timeout=600)
    return work, proc


def test_train_manipulation_batch_sweeps_the_strengths(batch_runs):
    work, proc = batch_runs
    assert proc.returncode == 0, proc.stderr[-3000:]
    for ln in ('0.0500', '0.1000'):
        run = work / 'm' / CAM / 'INet' / f'ln-{ln}' / 'fixed-codec' / '000'
        log = json.loads((run / 'training.json').read_text())
        summary = log['summary']
        assert summary['# Epochs'] == '2' and float(summary['NIP Regularization']) == float(ln)
        assert summary['Channel Compression'] == 'JPEG (soft) QF=50'
        assert log['distribution']['downsampling'] == 'pool'
        assert (run / 'models' / 'fan' / 'fan.npz').is_file()
        assert (run / 'models' / 'inet' / 'inet.npz').is_file()
        # each epoch's validation and the final one
        assert len(get(log, 'forensics/performance/accuracy/validation')) == 3


def test_test_fan_batch_revalidates_every_run(batch_runs):
    work, proc = batch_runs
    assert proc.returncode == 0, proc.stderr[-3000:]
    env = {**os.environ, 'PYTHON': sys.executable, 'RUNS_ROOT': 'm', 'DATASETS': 'data'}
    out = subprocess.run(
        [os.path.join(ROOT, 'neural_imaging_tpu_torch/cli/test_fan_batch.sh'), '--patch', '16',
         '--device', 'cpu'], cwd=work, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = re.findall(r'^== (\S+) on data$', out.stdout, re.M)
    assert sorted(runs) == sorted(os.path.relpath(p, work) for p, _, files in
                                  os.walk(work / 'm') if 'training.json' in files)
    accuracies = re.findall(r'^Accuracy validated/expected: ([\d.]+) / ([\d.]+)$', out.stdout,
                            re.M)
    assert len(accuracies) == len(runs) == 2
    for run, (validated, expected) in zip(runs, accuracies):
        logged = get(json.loads((work / run / 'training.json').read_text()),
                     'forensics/performance/accuracy/validation')[-1]
        assert float(expected) == pytest.approx(logged, abs=1e-4)
        assert 0 <= float(validated) <= 1


# the whole spec at full length, out of tier-1

@pytest.mark.slow
@pytest.mark.e2e
def test_full_spec_meets_every_gate(tmp_path, one_thread):
    root = str(tmp_path)
    harness.prepare_data(root, CAM)
    results = harness.run_all(SPEC, root, CAM, device='cpu')
    assert {name: r['status'] for name, r in results.items()} == dict.fromkeys(SPEC, 'PASS'), \
        {name: r['message'] for name, r in results.items()}
