"""The port's three trainers with ``parallel=`` over 2 gloo ranks (CPU
processes, one thread each, one launch with a 60 s deadline) against their
one-process runs at the same global batch, and the ``train_nip`` and
``train_manipulation`` CLIs as two processes joined by ``--coordinator/
--nproc/--procid`` against a one-process run, as the JAX package's
``tests/test_multihost.py`` holds its ``train_nip``.

Tolerances: the training and validation trajectories within rtol 1e-3, as
the JAX package's parity tests hold its mesh runs
(``tests/test_parallel.py``); the files are written once, by the primary:
rank 1's output directory stays empty (the trainers), and only rank 0 logs
a snapshot's save (the CLIs)."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from neural_imaging_tpu.data import fixtures
from neural_imaging_tpu_torch.parallel import launch, multihost

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), 'support'))
import torch_parallel_workers as workers  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH, BATCH, EPOCHS = 16, 4, 2
SPLIT = dict(n_images=8, v_images=4, val_rgb_patch_size=32, val_n_patches=1)
RTOL = 1e-3
DEADLINE_S = 60


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    raw = str(tmp_path_factory.mktemp('dp-raw'))
    fixtures.make_dataset(raw, n_images=12, height=64, width=64, seed=41)
    rgb = str(tmp_path_factory.mktemp('dp-rgb'))
    fixtures.make_dataset(rgb, n_images=12, height=64, width=64, seed=43, rgb_only=True)
    return raw, rgb


@pytest.fixture(scope='module')
def trainers(data_dirs, tmp_path_factory):
    raw, rgb = data_dirs
    root = str(tmp_path_factory.mktemp('dp-runs'))
    base = {'split': SPLIT, 'batch': BATCH, 'epochs': EPOCHS}
    specs = [('nip-host', 'nip', {**base, 'data_dir': raw, 'patch': PATCH,
                                  'device_data': False}),
             ('nip-device', 'nip', {**base, 'data_dir': raw, 'patch': PATCH,
                                    'device_data': True}),
             ('manipulation', 'manipulation', {**base, 'data_dir': raw, 'patch': PATCH,
                                               'fan_args': {'n_convolutions': 2,
                                                            'n_filters': 8, 'n_dense': 0}}),
             ('dcn', 'dcn', {**base, 'data_dir': rgb, 'patch': 32, 'seed': 7,
                             'device_data': False})]
    ranks = launch.run(workers.run_trainers, ['cpu', 'cpu'], args=(specs, root), threads=1,
                       timeout_s=DEADLINE_S)
    single = workers.run_trainers(None, specs, root)
    return ranks, single


def trajectories(performance):
    """{metric/scope: values} of a performance record (nested per model)."""
    out = {}
    for key, value in performance.items():
        if isinstance(value, dict) and not set(value) <= {'training', 'validation'}:
            out.update({f'{key}/{k}': v for k, v in trajectories(value).items()})
        elif isinstance(value, dict):
            out.update({f'{key}/{scope}': v for scope, v in value.items() if v})
    return out


@pytest.mark.parametrize('name', ['nip-host', 'nip-device', 'manipulation', 'dcn'])
def test_trainer_over_two_ranks_follows_the_one_process_run(trainers, name):
    ranks, single = trainers
    ref = trajectories(single[name]['performance'])
    assert any(k.endswith('loss/training') for k in ref)
    for r in ranks:
        got = trajectories(r[name]['performance'])
        assert got.keys() == ref.keys()
        for key, values in ref.items():
            np.testing.assert_allclose(np.asarray(got[key], dtype=np.float64),
                                       np.asarray(values, dtype=np.float64), rtol=RTOL,
                                       atol=1e-7, err_msg=f'{name}: {key}')
    assert ranks[0][name]['files'] == single[name]['files'] and single[name]['files']
    assert ranks[1][name]['files'] == []


# -- the CLIs as two processes ---------------------------------------------------------

def cli_command(module, args):
    return [sys.executable, '-m', f'neural_imaging_tpu_torch.cli.{module}', *args]


def run_two_processes(module, args):
    port = multihost.free_port()
    env = multihost.rank_environment()
    procs = [subprocess.Popen(cli_command(module, [*args, '--coordinator', f'127.0.0.1:{port}',
                                                   '--nproc', '2', '--procid', str(r)]),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env=env)
             for r in range(2)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f'rank {r}:\n{out[-3000:]}'
    return outputs


CLIS = {
    'train_nip': (['--nip', 'INet', '--cam', 'Cam', '--split', '8:4:1', '--epochs', '2',
                   '--patch', str(PATCH), '--batch', str(BATCH), '--val-schedule', '1',
                   '--device', 'cpu'], '--out', ('Cam', 'INet_gbrg_5x5', 'inet', 'progress.json')),
    'train_manipulation': (['--nip', 'INet', '--cam', 'Cam', '--split', '8:4:1', '--epochs', '2',
                            '--patch', str(PATCH), '--batch', str(BATCH), '--val-schedule', '1',
                            '--manip', 'sharpen', '--train', 'nip', '--scratch', '--fan',
                            "{'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}",
                            '--device', 'cpu'], '--dir',
                           ('Cam', 'INet', 'ln-0.1000', 'fixed-codec', '000', 'training.json')),
}


def losses_of(path):
    with open(path) as f:
        log = json.load(f)
    perf = log['performance'] if 'performance' in log else log['forensics']['performance']
    return perf['loss']


@pytest.mark.parametrize('module', sorted(CLIS))
def test_cli_as_two_processes_follows_the_one_process_run(module, data_dirs, tmp_path):
    args, out_flag, log_path = CLIS[module]
    args = [*args, '--data', data_dirs[0]]
    single = subprocess.run(cli_command(module, [*args, out_flag, str(tmp_path / 'single')]),
                            capture_output=True, text=True, cwd=ROOT, timeout=DEADLINE_S,
                            env=multihost.rank_environment())
    assert single.returncode == 0, single.stdout[-2000:] + single.stderr[-2000:]
    outputs = run_two_processes(module, [*args, out_flag, str(tmp_path / 'multi')])
    a = losses_of(os.path.join(tmp_path, 'multi', *log_path))
    b = losses_of(os.path.join(tmp_path, 'single', *log_path))
    for scope in ('training', 'validation'):
        assert len(a[scope]) == len(b[scope]) and b['training']
        np.testing.assert_allclose(a[scope], b[scope], rtol=RTOL, atol=1e-7)
    saved = re.compile(r'> \w+ --> \S+\.npz')      # a snapshot's save log line
    assert saved.search(outputs[0])
    assert not saved.search(outputs[1]), outputs[1][-2000:]
