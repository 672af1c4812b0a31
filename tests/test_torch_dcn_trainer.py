"""The port's DCN trainer (``training/compression.py``), its CLI
(``cli/train_dcn.py``), ``DCN.training_scan``, the codec's
``compress_n_stats`` / ``global_compress`` and the joint trainer with a
learned channel, against the JAX package on the CPU.

Both packages' ``train_dcn`` train a TwitterDCN (32 features, the JAX
package's initial weights given to both, the reference on its Pallas VJP
as in ``tests/test_torch_dcn.py``) on one directory of 10 procedural
64x96 RGB images (split 8:2:2, patch 32, batch 4, 3 epochs, validation
every 2), host-fed, the augmentations drawn from one numpy seed.

Tolerances: the first epoch's mean loss within 1e-3 relative (the same
batches; float32 in another summation order through the quantizer, whose
encoder gradients agree to 1e-3 of their scale); decodes of one latent by
the two packages within 1e-5; ``compress_n_stats``' bytes equal and its
SSIM, PSNR and entropy within 1e-6 relative; the device-resident step with
its augmentations off bit-equal to the host-fed step on the same batch;
the in-graph flip and gamma rates within 3σ of their probabilities over
``AUGMENT_DRAWS`` draws."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from flax import traverse_util

from neural_imaging_tpu.compression import codec as jcodec
from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JaxDataset
from neural_imaging_tpu.models import compression as jcompression
from neural_imaging_tpu.training import compression as jtraining
from neural_imaging_tpu_torch.cli import train_dcn as cli
from neural_imaging_tpu_torch.cli import train_manipulation as manipulation_cli
from neural_imaging_tpu_torch.compression import codec
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.models import base, compression
from neural_imaging_tpu_torch.parallel.mesh import Mesh
from neural_imaging_tpu_torch.parallel.train import DataParallel
from neural_imaging_tpu_torch.training import compression as training
from neural_imaging_tpu_torch.utils import jsonlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import train_nip as jax_cli  # noqa: E402  (the JAX package's scenario reader)

torch.set_num_threads(1)

SPLIT = dict(n_images=8, v_images=2, val_rgb_patch_size=32, val_n_patches=2)
PATCH, BATCH, EPOCHS, SCHEDULE, LR = 32, 4, 3, 2, 1e-4
SPEC = {'n_epochs': EPOCHS, 'batch_size': BATCH, 'patch_size': PATCH,
        'validation_schedule': SCHEDULE, 'learning_rate': LR}
EPOCH_LOSS_RTOL, DECODE_ATOL, STATS_RTOL = 1e-3, 1e-5, 1e-6
AUGMENT_DRAWS = 600
NO_AUGMENTATION = {'flip_h': 0.0, 'flip_v': 0.0, 'gamma': 0.0}


@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    return jfixtures.make_dataset(str(tmp_path_factory.mktemp('rgb')), n_images=10, height=64,
                                  width=96, seed=700, rgb_only=True)


def codec_pair(n_features=32):
    """The JAX TwitterDCN with its initial weights and the port's with the same."""
    ref = jcompression.TwitterDCN(patch_size=PATCH, n_features=n_features,
                                  use_pallas_quantization=True)
    port = compression.TwitterDCN(patch_size=PATCH, n_features=n_features, device='cpu')
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(ref.params, sep='/').items()}
    port.module.load_state_dict(base.convert_params(flat), strict=True)
    return ref, port


@pytest.fixture(scope='module')
def runs(data_dir, tmp_path_factory):
    """Both trainers on the fixture directory; the port's codec and both
    output directories."""
    root = tmp_path_factory.mktemp('dcn')
    ref, port = codec_pair()
    ref_dir = jtraining.train_dcn(ref, dict(SPEC), JaxDataset(data_dir, load='y', **SPLIT),
                                  directory=str(root / 'jax'), rng=np.random.default_rng(3))
    port_dir = training.train_dcn(port, dict(SPEC), Dataset(data_dir, load='y', **SPLIT),
                                  directory=str(root / 'port'), rng=np.random.default_rng(3))
    return port, ref_dir, port_dir


def test_first_epoch_matches_the_reference(runs):
    _, ref_dir, port_dir = runs
    ref, port = (jsonlog.load_json(os.path.join(d, 'progress.json'))['codec']['performance']
                 for d in (ref_dir, port_dir))
    for key in ('loss', 'ssim', 'entropy'):
        assert len(port[key]['training']) == len(ref[key]['training']) == EPOCHS, key
        assert len(port[key]['validation']) == len(ref[key]['validation']) == 2, key
        assert np.isfinite(port[key]['training'] + port[key]['validation']).all(), key
    first, first_ref = port['loss']['training'][0], ref['loss']['training'][0]
    assert abs(first - first_ref) <= EPOCH_LOSS_RTOL * abs(first_ref), (first, first_ref)


def keys_of(tree):
    if isinstance(tree, dict):
        return {k: keys_of(v) for k, v in tree.items()}
    return None


def test_run_directory_has_the_reference_schema(runs):
    _, ref_dir, port_dir = runs
    ref, port = (jsonlog.load_json(os.path.join(d, 'progress.json')) for d in (ref_dir, port_dir))
    assert keys_of(port) == keys_of(ref)
    assert port['training_spec'] == ref['training_spec']
    assert port['data'] == ref['data']
    assert {k: port['codec'][k] for k in ('model', 'init', 'args', 'codebook')} == \
        {k: ref['codec'][k] for k in ('model', 'init', 'args', 'codebook')}
    assert os.path.relpath(port_dir, os.path.dirname(os.path.dirname(os.path.dirname(
        port_dir)))) == os.path.join('TwitterDCN-32C', 'soft-codebook_Q-5bpf_S+_H+250.00',
                                     'twitterdcn')
    names = set(os.listdir(port_dir))
    assert {'progress.json', 'twitterdcn.npz', 'scalars.jsonl', training.OPTIMIZER_FILE,
            'thumbnails-00000.png', 'thumbnails-00002.png'} <= names
    with open(os.path.join(port_dir, 'scalars.jsonl')) as f:
        scalars = [json.loads(line) for line in f]
    with open(os.path.join(ref_dir, 'scalars.jsonl')) as f:
        assert [sorted(s) for s in scalars] == [sorted(json.loads(line)) for line in f]
    assert [s['step'] for s in scalars] == list(range(EPOCHS))


def test_port_snapshot_restores_in_the_reference(runs):
    port, _, port_dir = runs
    ref = jcodec.restore(port_dir)
    assert ref.model_code == port.model_code
    x = np.stack([jfixtures.procedural_image(32, 48, seed=s) for s in (1, 2)]).astype(np.float32)
    z = port.compress(x).numpy()
    np.testing.assert_array_equal(np.asarray(ref.compress(x)), z)
    np.testing.assert_allclose(np.asarray(ref.decompress(z)), port.decompress(z).numpy(),
                               atol=DECODE_ATOL)


def test_resume_continues_the_epoch_counter_and_the_adam_state(data_dir, tmp_path):
    """A run of 2 epochs (validation every epoch), then ``resume`` to 4: the
    reference's counter re-runs the last logged epoch, the history goes on
    and Adam's step counts go on from ``adam.pt``."""
    data = Dataset(data_dir, load='y', **SPLIT)
    spec = {**SPEC, 'n_epochs': 2, 'validation_schedule': 1}
    dcn = compression.TwitterDCN(patch_size=PATCH, n_features=8, device='cpu')
    out = training.train_dcn(dcn, spec, data, directory=str(tmp_path), rng=np.random.default_rng(1))
    first = jsonlog.load_json(os.path.join(out, 'progress.json'))
    assert first['training_spec']['current_epoch'] == 1
    resumed = compression.TwitterDCN(patch_size=PATCH, n_features=8, seed=5, device='cpu')
    training.train_dcn(resumed, {**spec, 'n_epochs': 4}, data, directory=str(tmp_path),
                       rng=np.random.default_rng(1), resume=True)
    progress = jsonlog.load_json(os.path.join(out, 'progress.json'))
    assert progress['training_spec']['current_epoch'] == 3
    assert progress['codec']['performance']['loss']['training'][:2] == \
        first['codec']['performance']['loss']['training']
    assert len(progress['codec']['performance']['loss']['training']) == 2 + 3
    n_batches = SPLIT['n_images'] // BATCH
    steps = {int(s['step']) for s in resumed.optimizer.state_dict()['state'].values()}
    assert steps == {(2 + 3) * n_batches}
    os.makedirs(tmp_path / 'empty' / 'TwitterDCN-4C' / 'soft-codebook_Q-5bpf_S+_H+250.00'
                / 'twitterdcn')
    with pytest.raises(FileNotFoundError):
        training.train_dcn(compression.TwitterDCN(patch_size=PATCH, n_features=4, device='cpu'),
                           spec, data, directory=str(tmp_path / 'empty'), resume=True)


def test_device_resident_step_without_augmentation_equals_the_host_fed_step(data_dir):
    data = Dataset(data_dir, load='y', **SPLIT)
    sampler = DeviceSampler(data, BATCH, PATCH, device='cpu')
    scanned = compression.TwitterDCN(patch_size=PATCH, n_features=8, device='cpu')
    stepped = compression.TwitterDCN(patch_size=PATCH, n_features=8, device='cpu')
    outs = scanned.training_scan(sampler, 2, LR, NO_AUGMENTATION)
    for step in range(2):
        out = stepped.training_step(sampler(step), LR)
        for key in ('loss', 'ssim', 'entropy'):
            assert torch.equal(outs[key][step], out[key]), (step, key)
    for (name, p), q in zip(scanned.module.named_parameters(), stepped.module.parameters()):
        assert torch.equal(p, q), name
    assert scanned._scan_step == 2


def test_device_resident_augmentations_draw_at_their_rates(data_dir):
    """With the default probabilities the scanned steps stay finite; the
    augmentation alone, drawn ``AUGMENT_DRAWS`` times from the scan's
    generator, flips and applies a gamma at rates within 3σ of 0.5, with
    every γ in [0.25, 3] and their mean within 3σ of 1.625."""
    dcn = compression.TwitterDCN(patch_size=PATCH, n_features=8, device='cpu')
    sampler = DeviceSampler(Dataset(data_dir, load='y', **SPLIT), BATCH, PATCH, device='cpu')
    outs = dcn.training_scan(sampler, 3, LR)
    assert all(bool(torch.isfinite(v).all()) for v in outs.values())

    x = 0.05 + 0.9 * torch.rand((3, 8, 8, 3), generator=torch.Generator().manual_seed(4))
    counts, gammas = {'flip_h': 0, 'flip_v': 0, 'gamma': 0}, []
    for _ in range(AUGMENT_DRAWS):
        y = dcn._augment(x, compression.AUGMENTATION_PROBS)
        matched = []
        for h in (False, True):
            for v in (False, True):
                xf = x.flip(2) if h else x
                xf = xf.flip(1) if v else xf
                ratio = torch.log(y) / torch.log(xf)        # 1/γ per image if y = xf^(1/γ)
                per_image = ratio.reshape(x.shape[0], -1)
                if float((per_image - per_image[:, :1]).abs().max()) < 1e-4:
                    matched.append((h, v, per_image[:, 0]))
        assert len(matched) == 1
        h, v, inv_gamma = matched[0]
        counts['flip_h'] += h
        counts['flip_v'] += v
        if float((inv_gamma - 1).abs().max()) > 1e-6:
            counts['gamma'] += 1
            gammas.extend((1 / inv_gamma).tolist())
    sigma = np.sqrt(0.25 / AUGMENT_DRAWS)
    for name, n in counts.items():
        assert abs(n / AUGMENT_DRAWS - 0.5) <= 3 * sigma, (name, n)
    gammas = np.array(gammas)
    assert gammas.min() >= 0.25 - 1e-4 and gammas.max() <= 3.0 + 1e-3
    assert abs(gammas.mean() - 1.625) <= 3 * (2.75 / np.sqrt(12)) / np.sqrt(len(gammas))


def test_resize_augmentation_and_parallel_are_refused(data_dir, tmp_path):
    """The resize is host-only (as in the reference): refused with
    device-resident data; the parallel trainer (ported) refuses a batch that
    does not divide over its ranks."""
    data = Dataset(data_dir, load='y', **SPLIT)
    dcn = compression.TwitterDCN(patch_size=PATCH, n_features=4, device='cpu')
    probs = {'resize': 0.5, 'flip_h': 0.5, 'flip_v': 0.5, 'gamma': 0.5}
    with pytest.raises(ValueError, match='host-only'):
        training.train_dcn(dcn, {**SPEC, 'augmentation_probs': probs}, data,
                           directory=str(tmp_path), device_data=True)
    parallel = DataParallel(Mesh('cpu', world_size=SPEC['batch_size'] + 1))
    with pytest.raises(ValueError, match='must divide across'):
        training.train_dcn(dcn, SPEC, data, directory=str(tmp_path), parallel=parallel)
    assert not os.listdir(tmp_path)


def test_cli_dry_reads_the_scenario_table(capsys):
    table = os.path.join(ROOT, 'config/twitter.csv')
    cli.main(['--param_list', table, '--group', '1', '--dry', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('# Scenario: TwitterDCN') == 1
    expected = [{k: v for k, v in s.items() if v == v}
                for s in jax_cli.get_scenarios(table, run_group=1)]
    assert f'# Scenario: TwitterDCN {expected[0]}' in out
    assert "'n_features': 32" in out
    with pytest.raises(SystemExit):
        cli.main(['--dcn', 'DCN2', '--dry', '--device', 'cpu'])


def test_cli_trains_a_codec(data_dir, tmp_path):
    cli.main(['--data', data_dir, '--split', '8:2:2', '--patch', str(PATCH), '--batch',
              str(BATCH), '--epochs', '2', '--val-schedule', '1', '--params',
              "{'n_features': 8}", '--out', str(tmp_path), '--device', 'cpu'])
    out = tmp_path / 'TwitterDCN-8C' / 'soft-codebook_Q-5bpf_S+_H+250.00' / 'twitterdcn'
    progress = jsonlog.load_json(out / 'progress.json')
    assert progress['training_spec']['batch_size'] == BATCH
    assert len(progress['codec']['performance']['ssim']['validation']) == 2
    assert jcodec.restore(str(out)).model_code == 'TwitterDCN-8C/soft-codebook_Q-5bpf_S+_H+250.00'


@pytest.mark.parametrize('extra, error, item', [
    (['--fill', 'results.txt'], SystemExit, "--fill must be '-' or a .csv path"),
    (['--devices', str(torch.cuda.device_count() + 1), '--device', 'cuda'], ValueError,
     f'asks for {torch.cuda.device_count() + 1} CUDA devices')], ids=['fill', 'devices'])
def test_cli_refuses_what_is_not_ported(tmp_path, extra, error, item):
    """--fill with a file that is not a CSV is refused before training, as
    the reference refuses it; --devices refuses more cards than the machine
    has."""
    with pytest.raises(error, match=item):
        cli.main(['--out', str(tmp_path), '--device', 'cpu', *extra])
    assert not os.listdir(tmp_path)


def test_cli_devices_trains_over_ranks_on_the_cpu(data_dir, tmp_path):
    """``--devices 2 --device cpu`` starts two CPU ranks over gloo: with
    device-resident data (whose draws are seeded) the run follows the
    one-process run within rtol 1e-3, and its files are written once."""
    args = ['--data', data_dir, '--split', '6:4:2', '--patch', str(PATCH), '--batch',
            str(BATCH), '--epochs', '2', '--val-schedule', '1', '--params',
            "{'n_features': 4}", '--device', 'cpu', '--device-data']
    cli.main([*args, '--out', str(tmp_path / 'single')])
    cli.main([*args, '--out', str(tmp_path / 'ranks'), '--devices', '2'])
    run = os.path.join('TwitterDCN-4C', 'soft-codebook_Q-5bpf_S+_H+250.00', 'twitterdcn')
    a, b = (jsonlog.load_json(tmp_path / root / run / 'progress.json')['codec']['performance']
            for root in ('ranks', 'single'))
    for key in ('loss', 'ssim', 'entropy'):
        for scope in ('training', 'validation'):
            assert len(a[key][scope]) == len(b[key][scope]) == 2
            np.testing.assert_allclose(a[key][scope], b[key][scope], rtol=1e-3)
    assert sorted(os.listdir(tmp_path / 'ranks' / run)) == \
        sorted(os.listdir(tmp_path / 'single' / run))


@pytest.fixture(scope='module')
def shipped():
    return jcodec.restore('32c'), codec.restore('32c', device='cpu')


def test_compress_n_stats_and_global_compress_match_the_reference(shipped):
    ref, port = shipped
    x = np.stack([jfixtures.procedural_image(64, 96, seed=s) for s in (3, 4)]).astype(np.float32)
    y, stats = codec.compress_n_stats(x, port)
    y_ref, stats_ref = jcodec.compress_n_stats(x, ref)
    np.testing.assert_allclose(y, y_ref, atol=DECODE_ATOL)
    np.testing.assert_array_equal(stats['bytes'], stats_ref['bytes'])
    np.testing.assert_array_equal(stats['bpp'], stats_ref['bpp'])
    for key in ('ssim', 'psnr', 'entropy'):
        np.testing.assert_allclose(stats[key], stats_ref[key], rtol=STATS_RTOL, err_msg=key)
    one = codec.compress_n_stats(x[:1], port)[1]
    assert set(one) == set(stats) and all(np.ndim(v) == 0 for v in one.values())
    assert codec.global_compress(port, x) == jcodec.global_compress(ref, x)


def test_joint_trainer_writes_a_restorable_codec(data_dir, tmp_path):
    """``train_manipulation`` with ONet and the 32c channel trainable (the
    framework scenario ``train-manipulation-dcn`` at 2 epochs): the run
    directory holds the codec's snapshot and a ``progress.json`` written for
    it, which the JAX package restores."""
    fan = json.dumps({'n_convolutions': 2, 'n_filters': 16, 'n_dense': 1})
    manipulation_cli.main(['--data', data_dir, '--cam', 'rgb', '--nip', 'ONet', '--split',
                           '8:2:2', '--epochs', '2', '--val-schedule', '1', '--dir',
                           str(tmp_path), '--lc', '0.1', '--ds', 'none', '--patch', '16',
                           '--batch', str(BATCH), '--train', 'dcn', '--manip',
                           'sharpen:1,gaussian:1', '--fan', fan, '--dcn', '32c',
                           '--device', 'cpu'])
    run = tmp_path / 'rgb' / 'ONet' / 'fixed-nip' / 'lc-0.1000' / '000'
    log = jsonlog.load_json(run / 'training.json')
    assert log['distribution']['compression'] == 'dcn'
    assert len(log['codec']['performance']['ssim']['validation']) == 3   # 2 points + the end
    codec_dir = run / 'models' / 'twitterdcn'
    assert {'twitterdcn.npz', 'progress.json'} <= set(os.listdir(codec_dir))
    ref = jcodec.restore(str(codec_dir))
    port = codec.restore(str(codec_dir), device='cpu')
    trained = base.load_flax_npz(codec_dir / 'twitterdcn.npz')
    shipped_weights = base.load_flax_npz(os.path.join(ROOT, 'data/models/dcn/baselines/32c/'
                                                      'twitterdcn/twitterdcn.npz'))
    assert max(float(np.abs(trained[k] - v).max()) for k, v in shipped_weights.items()) > 0
    z = port.compress(np.stack([jfixtures.procedural_image(32, 32, seed=9)]).astype(
        np.float32)).numpy()
    np.testing.assert_allclose(np.asarray(ref.decompress(z)), port.decompress(z).numpy(),
                               atol=DECODE_ATOL)
