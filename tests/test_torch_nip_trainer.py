"""The port's NIP trainer (``training/pipeline.py``) and its CLI
(``cli/train_nip.py``) against the JAX package's, on the CPU: both trainers
train a narrow UNet (n_steps 2, the JAX package's initial weights given to
both) on one fixture directory (6 procedural 64x96 pairs, split 4:2:2, raw
patch 16, batch 2, 4 epochs, validation every 2), host-fed and from
device-resident data.

Tolerances. Host-fed, both draw the same batches: per-epoch training
losses and validation losses within ``LOSS_RTOL`` relative (float32 in
another summation order, measured 1.2e-6), validation PSNR within
``PSNR_ATOL`` dB and SSIM within ``SSIM_ATOL``. Device-resident, the two
packages' samplers draw different patches (jax's PRNG against a
``torch.Generator``), so the histories agree only in form: the same
lengths, finite values, and validation PSNR within ``DEVICE_PSNR_ATOL`` dB
(a quarter of the 0.19 dB the run moves it; measured 0.015). Cross restores
develop within 1e-5."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
from neural_imaging_tpu.models import base as jbase
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.training import pipeline as jpipeline
from neural_imaging_tpu_torch.cli import train_manipulation as manipulation_cli
from neural_imaging_tpu_torch.cli import train_nip as cli
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import base, pipelines
from neural_imaging_tpu_torch.parallel.mesh import Mesh
from neural_imaging_tpu_torch.parallel.train import DataParallel
from neural_imaging_tpu_torch.training import pipeline
from neural_imaging_tpu_torch.training.pipeline import OPTIMIZER_FILE, train_nip_model
from neural_imaging_tpu_torch.utils import jsonlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import train_nip as jax_cli  # noqa: E402  (the JAX package's CLI)

torch.set_num_threads(1)

SPLIT = dict(n_images=4, v_images=2, val_rgb_patch_size=32, val_n_patches=2)
PATCH, BATCH, EPOCHS, SCHEDULE = 16, 2, 4, 2
UNET = {'n_steps': 2}
LOSS_RTOL, PSNR_ATOL, SSIM_ATOL, DEVICE_PSNR_ATOL = 1e-4, 1e-3, 1e-5, 0.05
CONFIGS = {'host': False, 'device': True}


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    return jfixtures.make_dataset(str(tmp_path_factory.mktemp('data')), n_images=6, height=64,
                                  width=96, seed=500)


def model_pair():
    """The JAX UNet with its initial weights and the port's with the same."""
    ref = jpipelines.UNet(patch_size=PATCH, **UNET)
    port = pipelines.UNet(patch_size=PATCH, device='cpu', **UNET)
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    port.module.load_state_dict(base.convert_params(flat, base.transposed_kernels(port.module)),
                                strict=True)
    return ref, port


def train_both(data_dir, root, device_data, **kwargs):
    ref, port = model_pair()
    spec = dict(n_epochs=EPOCHS, validation_schedule=SCHEDULE, patch_size=PATCH,
                batch_size=BATCH, device_data=device_data, **kwargs)
    ref_dir = jpipeline.train_nip_model(ref, 'SyntheticCam', data=JaxDataset(data_dir, **SPLIT),
                                        out_directory_root=os.path.join(root, 'jax'), **spec)
    port_dir = train_nip_model(port, 'SyntheticCam', data=Dataset(data_dir, **SPLIT),
                               out_directory_root=os.path.join(root, 'port'), **spec)
    return ref_dir, port_dir


@pytest.fixture(scope='module')
def runs(data_dir, tmp_path_factory):
    root = str(tmp_path_factory.mktemp('runs'))
    return {name: train_both(data_dir, os.path.join(root, name), device_data)
            for name, device_data in CONFIGS.items()}


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_progress_matches_reference(runs, config):
    ref_dir, port_dir = runs[config]
    ref, port = jsonlog.load_progress(ref_dir), jsonlog.load_progress(port_dir)
    assert port.keys() == ref.keys()
    assert port['args'] == ref['args'] and port['model'] == ref['model'] == 'UNet'
    assert port['init'] == ref['init']
    assert port['performance'].keys() == ref['performance'].keys()
    summary = {k: v for k, v in port['summary'].items() if k != 'Output directory'}
    assert summary == {k: v for k, v in ref['summary'].items() if k != 'Output directory'}
    perf, perf_ref = port['performance'], ref['performance']
    for metric, scopes in perf_ref.items():
        for scope, values in scopes.items():
            assert len(perf[metric][scope]) == len(values), (metric, scope)
            assert np.isfinite(perf[metric][scope]).all()
    if config == 'host':
        np.testing.assert_allclose(perf['loss']['training'], perf_ref['loss']['training'],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(perf['loss']['validation'], perf_ref['loss']['validation'],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(perf['psnr']['validation'], perf_ref['psnr']['validation'],
                                   atol=PSNR_ATOL)
        np.testing.assert_allclose(perf['ssim']['validation'], perf_ref['ssim']['validation'],
                                   atol=SSIM_ATOL)
    else:
        np.testing.assert_allclose(perf['psnr']['validation'], perf_ref['psnr']['validation'],
                                   atol=DEVICE_PSNR_ATOL)


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_snapshots_written(runs, config):
    _, port_dir = runs[config]
    assert sorted(os.listdir(port_dir)) == sorted(['progress.json', 'unet.npz', OPTIMIZER_FILE])
    assert port_dir.endswith(os.path.join('SyntheticCam', 'UNet_2', 'unet'))


def develop(model, seed=7):
    x = np.random.default_rng(seed).random((2, PATCH, PATCH, 4)).astype(np.float32)
    return np.asarray(model.process(x))


def test_each_package_restores_the_others_snapshot(runs):
    ref_dir, port_dir = runs['host']
    for directory in (ref_dir, port_dir):
        ref = jbase.restore(directory, jpipelines, patch_size=PATCH)
        port = base.restore(directory, pipelines, patch_size=PATCH, device='cpu')
        np.testing.assert_allclose(develop(port), develop(ref), atol=1e-5)
    # the host-fed runs trained the same weights
    np.testing.assert_allclose(
        develop(base.restore(port_dir, pipelines, device='cpu')),
        develop(jbase.restore(ref_dir, jpipelines)), atol=1e-4)


def test_resume_restores_the_adam_state(runs, data_dir, caplog):
    """Resume from the port's own run (its Adam state from adam.pt) and from
    the JAX package's (no adam.pt: fresh moments); both go on to 6 epochs."""
    ref_dir, port_dir = runs['host']
    for directory, message in ((port_dir, 'Restored the Adam state'),
                               (ref_dir, 'fresh Adam state')):
        model = pipelines.UNet(patch_size=PATCH, device='cpu', **UNET)
        root = directory[:directory.index('SyntheticCam')]
        caplog.clear()
        with caplog.at_level('INFO', logger='neural_imaging_tpu_torch'):
            train_nip_model(model, 'SyntheticCam', n_epochs=EPOCHS + 2,
                            validation_schedule=SCHEDULE, patch_size=PATCH, batch_size=BATCH,
                            data=Dataset(data_dir, **SPLIT), out_directory_root=root,
                            resume=True)
        assert message in caplog.text
        progress = jsonlog.load_progress(directory)
        assert progress['summary']['Epoch'] == EPOCHS + 1
        assert progress['summary']['Start epoch'] == EPOCHS - 1
        if directory == port_dir:
            state = torch.load(os.path.join(directory, OPTIMIZER_FILE))
            assert all(int(s['step']) > 0 for s in state['state'].values())


def test_existing_directory_is_kept(runs, data_dir):
    _, port_dir = runs['host']
    before = os.path.getmtime(os.path.join(port_dir, 'unet.npz'))
    out = train_nip_model(pipelines.UNet(patch_size=PATCH, device='cpu', **UNET), 'SyntheticCam',
                          n_epochs=2, patch_size=PATCH, batch_size=BATCH,
                          data=Dataset(data_dir, **SPLIT),
                          out_directory_root=port_dir[:port_dir.index('SyntheticCam')])
    assert out == port_dir and os.path.getmtime(os.path.join(port_dir, 'unet.npz')) == before


def learning_rates(monkeypatch, module, model_cls, losses):
    """Run ``module``'s trainer with its validation replaced by a fixed
    sequence of validation losses; returns the learning rates of its steps
    and its progress.json."""
    seen = []
    original = model_cls.training_step

    def step(self, bx, by, learning_rate=1e-4):
        seen.append(float(learning_rate))
        return original(self, bx, by, learning_rate)
    values = iter(losses)

    def validate(model, data, *args, **kwargs):
        v = next(values)
        return [0.5] * data.count_validation, [30.0] * data.count_validation, \
            [v] * data.count_validation, None
    monkeypatch.setattr(model_cls, 'training_step', step)
    monkeypatch.setattr(module, 'validate', validate)
    return seen


def test_lr_backoff_save_best_and_early_stop_match_reference(data_dir, tmp_path, monkeypatch):
    """The learning rate's 0.95 back-off on a 20% regression, the
    best-only snapshots and the early stop, under the same sequence of
    validation losses in both packages."""
    losses = [10, 9, 8, 7, 6, 5, 9, 9, 9, 4, 4.002, 4.001, 4.0, 4.0, 4.0, 4.0]
    ref, port = model_pair()
    ref_lrs = learning_rates(monkeypatch, jpipeline, jpipelines.UNet, losses)
    port_lrs = learning_rates(monkeypatch, pipeline, pipelines.UNet, losses)
    spec = dict(n_epochs=16, validation_schedule=1, patch_size=PATCH, batch_size=BATCH,
                save_best=True, validation_loss_threshold=1e-3)
    ref_dir = jpipeline.train_nip_model(ref, 'SyntheticCam', data=JaxDataset(data_dir, **SPLIT),
                                        out_directory_root=str(tmp_path / 'jax'), **spec)
    port_dir = train_nip_model(port, 'SyntheticCam', data=Dataset(data_dir, **SPLIT),
                               out_directory_root=str(tmp_path / 'port'), **spec)
    np.testing.assert_allclose(port_lrs, ref_lrs, rtol=1e-12)
    assert min(port_lrs) < max(port_lrs)                 # the back-off happened
    a, b = jsonlog.load_progress(port_dir), jsonlog.load_progress(ref_dir)
    for key in ('Epoch', 'Saved checkpoint'):
        assert a['summary'][key] == b['summary'][key], key
    assert a['summary']['Epoch'] < 15                   # stopped early
    assert a['performance']['loss']['validation'] == b['performance']['loss']['validation']


@pytest.mark.parametrize('kwargs, error', [
    ({'parallel': DataParallel(Mesh('cpu', world_size=BATCH + 1))}, ValueError),
    ({'data': None}, ValueError),
    ({'batch_size': 5}, ValueError)])
def test_trainer_refuses(data_dir, tmp_path, kwargs, error):
    """A batch that does not divide over the parallel trainer's ranks, no
    data, a batch larger than the data."""
    spec = dict(data=Dataset(data_dir, **SPLIT), patch_size=PATCH, batch_size=BATCH,
                out_directory_root=str(tmp_path))
    spec.update(kwargs)
    with pytest.raises(error, match='must divide across' if 'parallel' in kwargs else None):
        train_nip_model(pipelines.UNet(patch_size=PATCH, device='cpu', **UNET), 'Cam', **spec)


def test_trainer_refuses_a_nip_without_parameters(data_dir, tmp_path):
    with pytest.raises(ValueError, match='no parameters'):
        train_nip_model(pipelines.ONet(patch_size=PATCH, device='cpu'), 'Cam',
                        data=Dataset(data_dir, **SPLIT), patch_size=PATCH, batch_size=BATCH,
                        out_directory_root=str(tmp_path))


# -- the CLI ----------------------------------------------------------------------------

def cli_args(data_dir, out, *extra):
    return ['--cam', 'SyntheticCam', '--data', data_dir, '--split', '4:2:2', '--epochs', '2',
            '--patch', str(PATCH), '--batch', str(BATCH), '--val-schedule', '1', '--out', out,
            '--device', 'cpu', *extra]


def test_cli_trains_what_the_library_trains(data_dir, tmp_path):
    cli.main(cli_args(data_dir, str(tmp_path / 'cli'), '--nip', 'UNet', '--params',
                      json.dumps(UNET)))
    model = pipelines.UNet(patch_size=PATCH, device='cpu', **UNET)
    lib = train_nip_model(model, 'SyntheticCam', n_epochs=2, validation_schedule=1,
                          patch_size=PATCH, batch_size=BATCH, data=Dataset(data_dir, **SPLIT),
                          out_directory_root=str(tmp_path / 'lib'))
    cli_dir = os.path.join(tmp_path, 'cli', 'SyntheticCam', 'UNet_2', 'unet')
    a, b = jsonlog.load_progress(cli_dir), jsonlog.load_progress(lib)
    assert a['performance'] == b['performance'] and a['args'] == b['args']
    npz_a, npz_b = (base.load_flax_npz(os.path.join(d, 'unet.npz')) for d in (cli_dir, lib))
    assert all(np.array_equal(npz_a[k], npz_b[k]) for k in npz_b)


def test_cli_gives_a_classic_isp_its_camera(data_dir, tmp_path):
    """--cam of a camera in config/cameras.json sets the ClassicISP's CFA
    (D7000: RGGB) and sRGB matrix before training."""
    cli.main(cli_args(data_dir, str(tmp_path), '--nip', 'ClassicISP', '--cam', 'D7000',
                      '--params', "{'c_filters': [4]}", '--cameras-config',
                      os.path.join(ROOT, 'config/cameras.json')))
    progress = jsonlog.load_progress(os.path.join(tmp_path, 'D7000', 'ClassicISP_rggb_5x5_4-3R',
                                                  'classicisp'))
    assert progress['args']['cfa_pattern'] == 'rggb'


def scenario_table(path):
    path.write_text('kernel,c_filters,residual,active,run_group\n'
                    '5,"@(4,)",True,1,1\n'
                    '3,"@(4, 4)",False,1,2\n'
                    '5,@(),True,0,1\n'
                    '7,"@(8,)",True,1,1\n')
    return str(path)


@pytest.mark.parametrize('group', [None, 1, 2])
def test_hp_scenarios_match_the_reference_cli(tmp_path, group):
    table = scenario_table(tmp_path / 'hp.csv')
    got = cli.get_scenarios(table, run_group=group)
    expected = jax_cli.get_scenarios(table, run_group=group)
    assert got == expected
    assert [type(v) for s in got for v in s.values()] == \
        [type(v.item() if hasattr(v, 'item') else v) for s in expected for v in s.values()]


def test_cli_dry_prints_the_scenarios(tmp_path, capsys):
    table = scenario_table(tmp_path / 'hp.csv')
    cli.main(['--nip', 'Classic', '--hp', table, '--dry', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('# Scenario: ClassicISP') == 3
    assert "{'kernel': 7, 'c_filters': (8,), 'residual': True}" in out
    assert not os.path.exists(tmp_path / 'data')


@pytest.mark.parametrize('extra, error, item', [
    (['--fill', 'summary.txt'], ValueError, 'Invalid value for the results file'),
    (['--devices', str(torch.cuda.device_count() + 1), '--device', 'cuda'], ValueError,
     f'asks for {torch.cuda.device_count() + 1} CUDA devices'),
    (['--coordinator', 'localhost:1234'], ValueError, 'missing --nproc, --procid'),
    (['--nproc', '2'], ValueError, 'missing --coordinator, --procid'),
    (['--procid', '0'], ValueError, 'missing --coordinator, --nproc')],
    ids=['fill', 'devices', 'coordinator', 'nproc', 'procid'])
def test_cli_refuses_what_is_not_ported(data_dir, tmp_path, extra, error, item):
    """--fill with a file that is not a CSV is refused, as the reference
    refuses it; of the parallel flags, more cards than the machine has and a
    multi-process run without all three of its flags are refused. Nothing is
    written."""
    with pytest.raises(error, match=item):
        cli.main(cli_args(data_dir, str(tmp_path), *extra))
    assert not os.path.exists(tmp_path / 'SyntheticCam')


def test_joint_cli_trains_on_a_unet_snapshot(data_dir, tmp_path):
    """The NIP trainer's snapshot is what the joint trainer's --nip UNet
    starts from (its --nip-dir), as in the reference's workflow."""
    cli.main(cli_args(data_dir, str(tmp_path / 'nips'), '--nip', 'UNet', '--params',
                      json.dumps(UNET)))
    manipulation_cli.main([
        '--nip', 'UNet', '--nip-params', json.dumps(UNET), '--cam', 'SyntheticCam',
        '--data', data_dir, '--split', '4:2:2', '--epochs', '1', '--patch', str(PATCH),
        '--batch', str(BATCH), '--val-schedule', '1', '--train', 'nip', '--manip',
        'sharpen,gaussian', '--fan', "{'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}",
        '--dir', str(tmp_path / 'm'), '--nip-dir', str(tmp_path / 'nips'), '--device', 'cpu'])
    run = os.path.join(tmp_path, 'm', 'SyntheticCam', 'UNet', 'ln-0.1000', 'fixed-codec', '000')
    with open(os.path.join(run, 'training.json')) as f:
        log = json.load(f)
    assert log['nip']['model'] == 'UNet' and log['nip']['args']['n_steps'] == 2
    assert os.path.isfile(os.path.join(run, 'models', 'unet', 'unet.npz'))
