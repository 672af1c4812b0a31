"""The port's trainer against the JAX package's, on the CPU: both trainers run
on one fixture directory (6 procedural 64x96 pairs, split 4:2:2, raw patch
16, batch 2, 3 epochs, validation every epoch, augment off, the narrow FAN
with the JAX package's initial weights given to both, the shipped
SyntheticCam INet as the pre-trained NIP), for three configurations:

- 'fixed': the NIP fixed, the QF-50 soft JPEG channel;
- 'joint': NIP and a trainable QF-50 JPEG channel ('dcn') trained, λ 0.1 each;
  the reference's channel runs through its Pallas JPEG core (interpret mode),
  whose q-table gradient the port's K1 backward follows;
- 'none': NIP trained, no channel codec (the CLI's default) and no 'jpeg'
  manipulation: no JPEG on the path.

Tolerances: per-epoch training losses within 1e-4 relative, except in the
'fixed' run: there float32 rounding in another summation order moves a
dJPEG coefficient that lies at a rounding boundary by one q step in one
package and not in the other (on this data, 2 of its 6 steps: the FAN's
input moves by up to 1.5e-2 and its probabilities by 5.7e-3), so that run
is held to ``MAX_STEP_LOSS_DIFF`` (1e-3 relative), the bound the port sets
for two float32 runs of one step (``compare_steps``). The NIP's validation
PSNR within 1e-3 dB and SSIM within 1e-5; the JPEG channel's validation
PSNR and SSIM within 1e-4 relative and its entropy within 1e-3 bits.

Saved weights: each leaf's change over the run (saved minus initial) is
held against the reference's change: the norm of their difference within
``UPDATE_RTOL`` of the norm of the reference's change, and every entry that
the reference moved by at least ``STEADY`` of the summed learning rates
(Adam moves an entry by about lr a step while its gradient keeps its sign)
within ``UPDATE_ATOL``; a leaf the reference left unchanged must be left
unchanged. 'joint' and 'none' are held to 1e-3 and 1e-6 (measured at most
2.6e-4 and 1.1e-7); 'fixed', whose flipped coefficients change the FAN's
gradients on two steps, to 5e-2 and 3e-5 (measured 2.8e-2 and 1.5e-5).
``test_weight_check_refuses_a_wrong_update`` shows that the check fails a
leaf left unchanged, reversed, or moved without the learning rate's decay.

FAN accuracies must be equal except where a validation patch's top two
classes lie within ``DECISION_MARGIN`` (2e-2) of each other (reported by
``undecided``)."""
import argparse
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
from neural_imaging_tpu.models import forensics as jforensics
from neural_imaging_tpu.models import jpeg as jjpeg
from neural_imaging_tpu.models import pipelines as jpipelines
from neural_imaging_tpu.training import manipulation as jmanipulation
from neural_imaging_tpu.training import validation as jvalidation
from neural_imaging_tpu.workflows import ManipulationClassification as JaxFlow
from neural_imaging_tpu_torch.cli import train_manipulation as cli
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.models import base, forensics, jpeg, pipelines
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.training.manipulation import (LR_DECAY_RATE,
                                                            train_manipulation_nip)
from neural_imaging_tpu_torch.workflows.manipulation_classification import (
    DECISION_MARGIN, MAX_STEP_LOSS_DIFF, ManipulationClassification)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import test_fan  # noqa: E402  (the JAX package's re-validation CLI)

torch.set_num_threads(1)

NIP_DIR = os.path.join(ROOT, 'data/models/nip')
NIP_NPZ = os.path.join(NIP_DIR, 'SyntheticCam/INet_gbrg_5x5/inet/inet.npz')
SHIPPED_RUN = os.path.join(ROOT, 'data/m_quality/QualityRef/INet/fixed-nip/fixed-codec/000')
FAN_ARGS = {'n_convolutions': 2, 'n_filters': 8, 'n_dense': 0}
SPLIT = dict(n_images=4, v_images=2, val_rgb_patch_size=32, val_n_patches=2)
PATCH, BATCH, EPOCHS, LR = 16, 2, 3, 1e-4
STEPS_PER_EPOCH = SPLIT['n_images'] // BATCH
# Σ lr over the run: lr for epoch 0, then × LR_DECAY_RATE (the trainer's decay)
TOTAL_LR = LR * STEPS_PER_EPOCH * (1 + LR_DECAY_RATE * (EPOCHS - 1))
JPEG50 = {'quality': 50, 'codec': 'soft'}

# name → (distribution, trainable, λ_nip, λ_dcn, manipulations)
CONFIGS = {
    'fixed': ({'downsampling': 'pool', 'compression': 'jpeg', 'compression_params': JPEG50},
              set(), 0.0, 0.0, None),
    'joint': ({'downsampling': 'pool', 'compression': 'jpeg',
               'compression_params': {**JPEG50, 'trainable': True}}, {'nip', 'dcn'}, 0.1, 0.1,
              None),
    'none': ({'downsampling': 'pool', 'compression': 'none'}, {'nip'}, 0.1, 0.0,
             ['sharpen', 'resample', 'gaussian']),
}
LOSS_RTOL = {'fixed': MAX_STEP_LOSS_DIFF, 'joint': 1e-4, 'none': 1e-4}
UPDATE_RTOL = {'fixed': 5e-2, 'joint': 1e-3, 'none': 1e-3}
UPDATE_ATOL = {'fixed': 3e-5, 'joint': 1e-6, 'none': 1e-6}
STEADY = 0.95
MOVED = {'fixed': {'fan'}, 'joint': {'fan', 'inet', 'jpeg'}, 'none': {'fan', 'inet'}}
PSNR_ATOL, SSIM_ATOL = 1e-3, 1e-5


class PallasJPEG(jjpeg.DifferentiableJPEG):
    """The reference's differentiable JPEG through its Pallas core at every size."""

    def __call__(self, x, params=None, q_luma=None, q_chroma=None):
        params = params if params is not None else self.params
        q_luma = params['q_mtx_luma'] if q_luma is None else q_luma
        q_chroma = params['q_mtx_chroma'] if q_chroma is None else q_chroma
        return jjpeg.jpeg_forward(jnp.asarray(x, jnp.float32), q_luma, q_chroma,
                                  rounding=self.rounding_approximation, impl='pallas')


def training_spec(config, **changes):
    _, _, lambda_nip, lambda_dcn, _ = CONFIGS[config]
    return {'camera_name': 'SyntheticCam', 'use_pretrained_nip': True, 'patch_size': PATCH,
            'batch_size': BATCH, 'n_epochs': EPOCHS, 'validation_schedule': 1,
            'learning_rate': LR, 'lambda_nip': lambda_nip, 'lambda_dcn': lambda_dcn,
            'run_number': 0, 'augment': False, **changes}


def flat_params(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep='/').items()}


def files_under(directory):
    return sorted(os.path.relpath(os.path.join(d, f), directory)
                  for d, _, names in os.walk(directory) for f in names)


def run_dir(root, config):
    _, trainable, lambda_nip, lambda_dcn, _ = CONFIGS[config]
    return os.path.join(root, 'SyntheticCam', 'INet',
                        f'ln-{lambda_nip:.4f}' if 'nip' in trainable else 'fixed-nip',
                        f'lc-{lambda_dcn:.4f}' if 'dcn' in trainable else 'fixed-codec', '000')


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    return jfixtures.make_dataset(str(tmp_path_factory.mktemp('data')), n_images=6,
                                  height=64, width=96, seed=500)


@pytest.fixture(scope='module')
def runs(data_dir, tmp_path_factory):
    """{config: (JAX run directory, port run directory, initial weights)}: both
    trainers, each on its own Dataset of ``data_dir``, from the same FAN weights;
    the initial weights of each saved model ({'fan', 'inet'[, 'jpeg']}: flat
    leaves) are the JAX FAN's, the pre-trained INet and the JAX channel's
    q-tables."""
    out = {}
    for config, (distribution, trainable, _, _, manipulations) in CONFIGS.items():
        root = str(tmp_path_factory.mktemp(config))
        ref = JaxFlow('INet', manipulations=manipulations, distribution=distribution,
                      fan_args=FAN_ARGS, trainable=set(trainable), raw_patch_size=PATCH)
        if ref.codec is not None and ref.codec.trainable:
            ref.codec._model.__class__ = PallasJPEG
        initial_fan = flat_params(ref.fan.params)
        initial = {'fan': initial_fan, 'inet': base.load_flax_npz(NIP_NPZ)}
        if 'dcn' in trainable:
            initial['jpeg'] = flat_params(ref.params['dcn'])
        jmanipulation.train_manipulation_nip(
            ref, training_spec(config), JaxDataset(data_dir, **SPLIT),
            directories={'root': os.path.join(root, 'ref'), 'nip_snapshots': NIP_DIR})

        port = ManipulationClassification('INet', manipulations=manipulations,
                                          distribution=distribution, fan_args=FAN_ARGS,
                                          trainable=set(trainable), raw_patch_size=PATCH,
                                          device='cpu')
        port.fan.module.load_state_dict(base.convert_params(initial_fan), strict=True)
        train_manipulation_nip(port, training_spec(config), Dataset(data_dir, **SPLIT),
                               directories={'root': os.path.join(root, 'port'),
                                            'nip_snapshots': NIP_DIR})
        out[config] = (run_dir(os.path.join(root, 'ref'), config),
                       run_dir(os.path.join(root, 'port'), config), initial)
    return out


def logs(runs, config):
    ref_dir, port_dir, _ = runs[config]
    with open(os.path.join(ref_dir, 'training.json')) as f:
        ref = json.load(f)
    with open(os.path.join(port_dir, 'training.json')) as f:
        port = json.load(f)
    return ref, port


@pytest.mark.parametrize('config', list(CONFIGS))
def test_run_directories_hold_the_same_files(runs, config):
    ref_dir, port_dir, _ = runs[config]
    ref_files = [f for f in files_under(ref_dir) if not f.endswith('.jpg')]
    assert files_under(port_dir) == ref_files
    expected = {'training.json', 'models/fan/fan.npz', 'models/inet/inet.npz'}
    if config == 'joint':
        expected.add('models/jpeg/jpeg.npz')
    assert set(ref_files) == expected


@pytest.mark.parametrize('config', list(CONFIGS))
def test_training_logs_match(runs, config):
    ref, port = logs(runs, config)
    assert list(port) == list(ref)
    for key in ('summary', 'distribution', 'channel_precision', 'manipulations'):
        assert port[key] == ref[key], key
    for part in ('nip', 'forensics', 'codec'):
        if part not in ref:
            continue
        assert list(port[part]) == list(ref[part])
        for key in ('model', 'init', 'args'):
            assert port[part].get(key) == ref[part].get(key), (part, key)
        assert {k: {s: len(v) for s, v in m.items()} if isinstance(m, dict) else len(m)
                for k, m in port[part]['performance'].items()} == \
               {k: {s: len(v) for s, v in m.items()} if isinstance(m, dict) else len(m)
                for k, m in ref[part]['performance'].items()}


@pytest.mark.parametrize('config', list(CONFIGS))
def test_training_losses_match(runs, config):
    ref, port = logs(runs, config)
    for part in ('forensics', 'nip'):
        losses = port[part]['performance']['loss']['training']
        assert len(losses) == EPOCHS
        np.testing.assert_allclose(losses, ref[part]['performance']['loss']['training'],
                                   rtol=LOSS_RTOL[config])


@pytest.mark.parametrize('config', ['joint', 'none'])
def test_nip_validation_matches(runs, config):
    ref, port = logs(runs, config)
    perf, ref_perf = port['nip']['performance'], ref['nip']['performance']
    assert len(perf['psnr']['validation']) == EPOCHS + 1
    np.testing.assert_allclose(perf['psnr']['validation'], ref_perf['psnr']['validation'],
                               rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(perf['ssim']['validation'], ref_perf['ssim']['validation'],
                               rtol=0, atol=SSIM_ATOL)
    np.testing.assert_allclose(perf['loss']['validation'], ref_perf['loss']['validation'],
                               rtol=1e-3)


def test_jpeg_validation_matches(runs):
    ref, port = logs(runs, 'joint')
    perf, ref_perf = port['codec']['performance'], ref['codec']['performance']
    assert len(perf['psnr']['validation']) == EPOCHS
    for metric, rtol, atol in (('psnr', 1e-4, 0), ('ssim', 1e-4, 0), ('entropy', 0, 1e-3)):
        np.testing.assert_allclose(perf[metric]['validation'], ref_perf[metric]['validation'],
                                   rtol=rtol, atol=atol)


def undecided(probabilities):
    """Rows whose top two classes lie within DECISION_MARGIN of each other."""
    top2 = np.sort(np.asarray(probabilities), axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] <= DECISION_MARGIN


def assert_accuracy(accuracy, expected, probabilities):
    """``accuracy`` equals ``expected`` unless undecided rows explain the gap."""
    wrong = round(abs(accuracy - expected) * len(probabilities))
    ties = int(undecided(probabilities).sum())
    assert wrong <= ties, (accuracy, expected, ties)
    if wrong:
        print(f'accuracy {accuracy} vs {expected}: {wrong} of {ties} undecided rows differ')


def port_probabilities(flow, data):
    x, _ = data.validation_tensors('cpu')
    return np.concatenate([flow.run_workflow(x[i:i + 10])[-1].numpy()
                           for i in range(0, data.count_validation, 10)])


def jax_probabilities(flow, data):
    x, _ = data.next_validation_batch(0, data.count_validation)
    return np.concatenate([np.asarray(flow.run_workflow(x[i:i + 10])[-1])
                           for i in range(0, data.count_validation, 10)])


@pytest.mark.parametrize('config', list(CONFIGS))
def test_fan_accuracy_matches(runs, data_dir, config):
    ref, port = logs(runs, config)
    accuracy = port['forensics']['performance']['accuracy']['validation']
    ref_accuracy = ref['forensics']['performance']['accuracy']['validation']
    assert len(accuracy) == EPOCHS + 1
    flow = ManipulationClassification.restore(runs[config][1], PATCH, device='cpu')
    probabilities = port_probabilities(flow, Dataset(data_dir, **SPLIT))
    assert_accuracy(accuracy[-1], ref_accuracy[-1], probabilities)
    # a decision that flips moves one entry of its row by 1 / (patches a class)
    np.testing.assert_allclose(port['forensics']['performance']['confusion'],
                               ref['forensics']['performance']['confusion'], rtol=0,
                               atol=int(undecided(probabilities).sum()) / 4 + 1e-12)


def saved_models(config):
    return ('fan', 'inet') + (('jpeg',) if config == 'joint' else ())


def saved_changes(runs, config):
    """{model/leaf: (port's change, reference's change)} over the run."""
    ref_dir, port_dir, initial = runs[config]
    out = {}
    for model in saved_models(config):
        ref = base.load_flax_npz(os.path.join(ref_dir, 'models', model, f'{model}.npz'))
        port = base.load_flax_npz(os.path.join(port_dir, 'models', model, f'{model}.npz'))
        assert sorted(port) == sorted(ref) == sorted(initial[model])
        for k, v in ref.items():
            assert port[k].shape == v.shape and port[k].dtype == v.dtype == np.float32
            out[f'{model}/{k}'] = (port[k] - initial[model][k], v - initial[model][k])
    return out


def assert_moved_as_reference(moved, moved_ref, config, name):
    """A leaf's change ``moved`` against the reference's ``moved_ref`` (see
    the module's docstring)."""
    if not moved_ref.any():
        np.testing.assert_array_equal(moved, moved_ref, err_msg=f'{name} moved')
        return
    rel = float(np.linalg.norm(moved - moved_ref) / np.linalg.norm(moved_ref))
    assert rel <= UPDATE_RTOL[config], f'{name}: change off by {rel:.3g} of its norm'
    steady = np.abs(moved_ref) >= STEADY * TOTAL_LR
    diff = float(np.abs(moved - moved_ref)[steady].max(initial=0))
    assert diff <= UPDATE_ATOL[config], f'{name}: a steadily moved entry off by {diff:.3g}'


@pytest.mark.parametrize('config', list(CONFIGS))
def test_saved_weights_match(runs, config):
    changes = saved_changes(runs, config)
    for name, (moved, moved_ref) in changes.items():
        assert_moved_as_reference(moved, moved_ref, config, name)
    assert {n.split('/')[0] for n, (_, m) in changes.items() if m.any()} == MOVED[config]


WRONG_UPDATES = {
    'unchanged': lambda moved_ref: np.zeros_like(moved_ref),
    'reversed': lambda moved_ref: -moved_ref,
    # every step at the initial lr: Σ lr of 6 steps instead of TOTAL_LR
    'undecayed': lambda moved_ref: moved_ref * (LR * EPOCHS * STEPS_PER_EPOCH / TOTAL_LR),
}


@pytest.mark.parametrize('wrong', list(WRONG_UPDATES))
@pytest.mark.parametrize('config', list(CONFIGS))
def test_weight_check_refuses_a_wrong_update(runs, config, wrong):
    """``assert_moved_as_reference`` fails every leaf the reference moved
    (the FAN's, the NIP's and the q-tables') when its change is replaced by a
    wrong one."""
    checked = set()
    for name, (_, moved_ref) in saved_changes(runs, config).items():
        if moved_ref.any():
            with pytest.raises(AssertionError):
                assert_moved_as_reference(WRONG_UPDATES[wrong](moved_ref), moved_ref, config, name)
            checked.add(name.split('/')[0])
    assert checked == MOVED[config]


def test_trained_weights_moved(runs):
    _, port_dir, initial = runs['fixed']
    saved = base.load_flax_npz(os.path.join(port_dir, 'models/fan/fan.npz'))
    assert max(float(np.abs(saved[k] - v).max()) for k, v in initial['fan'].items()) > LR


# -- checkpoints ------------------------------------------------------------------------

@pytest.mark.parametrize('model', ['fan', 'inet'])
def test_save_model_writes_the_shipped_format(tmp_path, model):
    flow = ManipulationClassification.restore(SHIPPED_RUN, 128, device='cpu')
    getattr(flow, 'fan' if model == 'fan' else 'nip').save_model(str(tmp_path))
    saved = base.load_flax_npz(os.path.join(tmp_path, model, f'{model}.npz'))
    shipped = base.load_flax_npz(os.path.join(SHIPPED_RUN, 'models', model, f'{model}.npz'))
    assert {k: (v.shape, v.dtype) for k, v in saved.items()} == \
           {k: (v.shape, v.dtype) for k, v in shipped.items()}
    for k, v in shipped.items():
        np.testing.assert_array_equal(saved[k], v)


def test_trainable_jpeg_saves_as_the_reference(tmp_path):
    jpeg.JPEG(50, trainable=True, device='cpu').save_model(str(tmp_path / 'port'))
    jjpeg.JPEG(50, trainable=True).save_model(str(tmp_path / 'ref'))
    saved = base.load_flax_npz(os.path.join(tmp_path, 'port/jpeg/jpeg.npz'))
    ref = base.load_flax_npz(os.path.join(tmp_path, 'ref/jpeg/jpeg.npz'))
    assert sorted(saved) == sorted(ref)
    for k, v in ref.items():
        assert saved[k].dtype == v.dtype and saved[k].shape == v.shape
        np.testing.assert_array_equal(saved[k], v)


@pytest.mark.parametrize('model', ['fan', 'inet'])
def test_reference_loads_a_port_checkpoint(tmp_path, model):
    """The port's model with perturbed weights, saved, loaded by the JAX
    package's ``load_model``: the same forward within 1e-5."""
    gen = torch.Generator().manual_seed(3)
    if model == 'fan':
        port = forensics.FAN(n_classes=5, patch_size=32, device='cpu', **FAN_ARGS)
        ref = jforensics.FAN(n_classes=5, patch_size=32, **FAN_ARGS)
        x = np.random.default_rng(0).random((3, 32, 32, 3)).astype(np.float32)
    else:
        port = pipelines.INet(patch_size=16, device='cpu')
        ref = jpipelines.INet(patch_size=16)
        x = np.random.default_rng(0).random((3, 16, 16, 4)).astype(np.float32)
    with torch.no_grad():
        for p in port.module.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
    port.save_model(str(tmp_path))
    ref.load_model(str(tmp_path))
    np.testing.assert_allclose(port.process(x).numpy(), np.asarray(ref.process(x)),
                               rtol=0, atol=1e-5)


# -- restoring the other package's run ----------------------------------------------------

def restore_args():
    return argparse.Namespace(jpeg=None, codec=None, dcn=None, ds=None, manip=None, patch=PATCH,
                              channel_dtype=None, channel_jpeg_dtype=None,
                              manip_jpeg_dtype=None)


@pytest.mark.parametrize('config', list(CONFIGS))
def test_reference_restores_the_port_run(runs, data_dir, config):
    flow, expected = test_fan.restore_flow(os.path.join(runs[config][1], 'training.json'),
                                           restore_args())
    data = JaxDataset(data_dir, **SPLIT)
    accuracy, _ = jvalidation.validate_fan(flow, data)
    assert_accuracy(accuracy, expected, jax_probabilities(flow, data))


@pytest.mark.parametrize('config', list(CONFIGS))
def test_port_restores_the_reference_run(runs, data_dir, config):
    flow = ManipulationClassification.restore(runs[config][0], PATCH, device='cpu')
    data = Dataset(data_dir, **SPLIT)
    accuracy, _ = validation.validate_fan(flow, data)
    expected = logs(runs, config)[0]['forensics']['performance']['accuracy']['validation'][-1]
    assert_accuracy(accuracy, expected, port_probabilities(flow, data))


# -- the CLI, the device-resident trainer and options not ported -------------------------------

def cli_args(data_dir, out, *extra):
    return ['--nip', 'INet', '--cam', 'SyntheticCam', '--data', data_dir, '--split', '4:2:2',
            '--epochs', '2', '--patch', str(PATCH), '--batch', str(BATCH), '--val-schedule', '1',
            '--fan', json.dumps(FAN_ARGS), '--dir', out, '--nip-dir', NIP_DIR,
            '--device', 'cpu', *extra]


def test_cli_builds_what_the_library_builds(data_dir, tmp_path):
    """A λ_nip sweep through the CLI (one flow, reinitialized) against a
    fresh flow and trainer call for each point on one Dataset (whose draws
    go on from point to point, as in the CLI): the same files and logs."""
    cli.main(cli_args(data_dir, str(tmp_path / 'cli'), '--train', 'nip', '--ln', '0.1', '0.2'))
    data = Dataset(data_dir, **SPLIT)
    for ln in (0.1, 0.2):
        flow = ManipulationClassification('INet', distribution={'downsampling': 'pool',
                                                                'compression': 'none'},
                                          fan_args=FAN_ARGS, trainable={'nip'},
                                          raw_patch_size=PATCH, device='cpu')
        train_manipulation_nip(flow, {**training_spec('none', n_epochs=2), 'lambda_nip': ln},
                               data, directories={'root': str(tmp_path / 'lib'),
                                            'nip_snapshots': NIP_DIR})
    assert files_under(tmp_path / 'cli') == files_under(tmp_path / 'lib')
    assert len(files_under(tmp_path / 'lib')) == 6
    for name in files_under(tmp_path / 'lib'):
        if name.endswith('training.json'):
            with open(tmp_path / 'cli' / name) as f, open(tmp_path / 'lib' / name) as g:
                assert json.load(f) == json.load(g)
        else:
            a = base.load_flax_npz(tmp_path / 'cli' / name)
            b = base.load_flax_npz(tmp_path / 'lib' / name)
            assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize('extra, item', [
    (['--devices', 'auto'], 'item 5'),
    (['--coordinator', 'localhost:1234'], 'item 5'),
    (['--nproc', '2'], 'item 5'),
    (['--procid', '0'], 'item 5'),
], ids=['devices', 'coordinator', 'nproc', 'procid'])
def test_cli_refuses_what_is_not_ported(data_dir, tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(cli_args(data_dir, str(tmp_path), *extra))
    assert not os.path.exists(tmp_path / 'SyntheticCam')


def test_cli_trains_with_jpeg_mode_libjpeg(data_dir, tmp_path):
    """``--jpeg_mode libjpeg``: the run logs the reference's libjpeg channel
    (its codec summary and distribution), and since the flow rounds 'soft' in its
    place, it trains as the ``--jpeg_mode soft`` run does, loss for loss;
    ``--jpeg-trainable`` with it is refused, as by the reference's CLI."""
    logs = {}
    for mode in ('libjpeg', 'soft'):
        root = str(tmp_path / mode)
        cli.main(cli_args(data_dir, root, '--jpeg', '50', '--jpeg_mode', mode, '--epochs', '1'))
        with open(os.path.join(run_dir(root, 'fixed'), 'training.json')) as f:
            logs[mode] = json.load(f)
    ref = JaxFlow('INet', distribution={'downsampling': 'pool', 'compression': 'jpeg',
                                        'compression_params': {'quality': 50,
                                                               'codec': 'libjpeg',
                                                               'trainable': False}},
                  fan_args=FAN_ARGS, raw_patch_size=PATCH)
    assert logs['libjpeg']['summary']['Channel Compression'] == ref.codec.summary() == \
        'JPEG (libjpeg) QF=50'
    assert logs['libjpeg']['distribution']['compression_params']['codec'] == 'libjpeg'
    for part in ('forensics', 'nip'):
        assert (logs['libjpeg'][part]['performance']['loss']
                == logs['soft'][part]['performance']['loss'])
    with pytest.raises(SystemExit):
        cli.main(cli_args(data_dir, str(tmp_path / 'x'), '--jpeg', '50', '--jpeg_mode',
                          'libjpeg', '--jpeg-trainable'))


@pytest.mark.parametrize('flag, key', [('--channel-dtype', 'channel_dtype'),
                                       ('--channel-jpeg-dtype', 'channel_jpeg_dtype'),
                                       ('--manip-jpeg-dtype', 'manip_jpeg_dtype')],
                         ids=['channel-dtype', 'channel-jpeg-dtype', 'manip-jpeg-dtype'])
def test_cli_takes_the_bf16_flags(data_dir, tmp_path, flag, key):
    """Each bfloat16 flag reaches the flow: the run's ``training.json``
    records it (and float32 for the others), and its restore builds it."""
    cli.main(cli_args(data_dir, str(tmp_path), '--jpeg', '50', flag, 'bfloat16'))
    run = run_dir(str(tmp_path), 'fixed')
    with open(os.path.join(run, 'training.json')) as f:
        precision = json.load(f)['channel_precision']
    assert precision == {k: 'bfloat16' if k == key else 'float32'
                         for k in ('channel_dtype', 'channel_jpeg_dtype', 'manip_jpeg_dtype')}
    assert ManipulationClassification.restore(run, PATCH,
                                              device='cpu').channel_precision == precision


def test_trainer_refuses_the_parallel_trainer():
    flow = ManipulationClassification('INet', raw_patch_size=PATCH, device='cpu')
    with pytest.raises(NotImplementedError, match='item 5'):
        train_manipulation_nip(flow, training_spec('fixed'), None, parallel=object())


def test_device_resident_trainer_on_the_cpu(data_dir, tmp_path, caplog):
    """One ``training_scan`` an epoch, and a debug line where each validation
    starts (what ``chip_smoke.py`` times the epochs by)."""
    flow = ManipulationClassification('INet', fan_args=FAN_ARGS, trainable={'nip'},
                                      raw_patch_size=PATCH, device='cpu')
    before = base.flax_params(flow.fan.module.named_parameters())
    with caplog.at_level('DEBUG', logger='neural_imaging_tpu_torch'):
        train_manipulation_nip(flow, training_spec('none', n_epochs=4, validation_schedule=2),
                               Dataset(data_dir, **SPLIT), device_data=True,
                               directories={'root': str(tmp_path), 'nip_snapshots': NIP_DIR})
    with open(os.path.join(run_dir(str(tmp_path), 'none'), 'training.json')) as f:
        log = json.load(f)
    losses = log['forensics']['performance']['loss']['training']
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite(log['nip']['performance']['loss']['training']).all()
    assert len(log['forensics']['performance']['accuracy']['validation']) == 3
    after = base.load_flax_npz(os.path.join(run_dir(str(tmp_path), 'none'), 'models/fan/fan.npz'))
    assert max(float(np.abs(after[k] - v).max()) for k, v in before.items()) > LR
    assert flow._scan_step == 4 * STEPS_PER_EPOCH
    assert [r.getMessage() for r in caplog.records if r.getMessage().endswith('validating')] == \
        ['epoch 0: validating', 'epoch 2: validating', 'epoch 3: validating']


def test_training_scan_draws_from_the_sampler_and_moves_the_fan(data_dir):
    flow = ManipulationClassification('INet', fan_args=FAN_ARGS, trainable={'nip'},
                                      raw_patch_size=PATCH, device='cpu')
    flow.nan_check = False
    sampler = DeviceSampler(Dataset(data_dir, **SPLIT), BATCH, 2 * PATCH, device='cpu')
    before = {k: p.detach().clone() for k, p in flow.fan.module.named_parameters()}
    losses, nip_losses = flow.training_scan(sampler, 3, lambda_nip=0.1)
    assert losses.shape == nip_losses.shape == (3,)
    assert bool(torch.isfinite(losses).all() and torch.isfinite(nip_losses).all())
    assert len(flow._finite_flags) == 3 and flow._scan_step == 3
    flow.assert_finite()
    assert max(float((p.detach() - before[k]).abs().max())
               for k, p in flow.fan.module.named_parameters()) > 0
    # the same draws as the sampler's steps 0-2: a replay from the start agrees
    flow.reinitialize()
    assert flow._scan_step == 0
    again, _ = flow.training_scan(sampler, 3, lambda_nip=0.1)
    assert torch.equal(again, losses)
