"""The port runs on a machine without JAX, flax, optax, PIL or imageio, and
without the JAX package: its modules, chip_smoke.py and the scripts that run
beside it on the card must import with all of those blocked. Its entry points default to CUDA and must refuse to run
without a card, and chip_smoke.py must fail without one."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import neural_imaging_tpu_torch
from neural_imaging_tpu_torch.cli import (diff_nip, test_dcn, test_dcn_rate_dist, test_fan,
                                          test_jpeg, test_nip, train_dcn, train_manipulation,
                                          train_nip)
from neural_imaging_tpu_torch.compression import codec, ratedistortion
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.models import base, compression, forensics, jpeg, pipelines
from neural_imaging_tpu_torch.utils import device as device_utils
from neural_imaging_tpu_torch.workflows import manipulation_classification

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'imageio', 'neural_imaging_tpu', 'tqdm',
           'matplotlib', 'pandas', 'rawpy', 'cv2')


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(neural_imaging_tpu_torch.__path__,
                                                        'neural_imaging_tpu_torch.'))


def run_python(code, **env):
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_port_and_chip_smoke_import_without_jax_pil_imageio_or_the_jax_package():
    modules = port_modules() + ['chip_smoke', 'profile_torch_slice', 'profile_torch_dcn',
                                'sass_costs', 'bench_codebook_kernels', 'check_division']
    for name in ('ops.hopper.jpeg8x8', 'ops.hopper.codebook', 'ops.ssim', 'models.compression',
                 'compression.codec', 'compression.entropy', 'data.png', 'data.fixtures',
                 'data.dataset', 'data.prefetch', 'data.device_sampler', 'training.validation',
                 'training.manipulation', 'cli.train_manipulation', 'training.pipeline',
                 'cli.train_nip', 'models.pipelines', 'training.compression', 'cli.train_dcn',
                 'cli.test_fan', 'utils.results_data', 'utils.native', 'data.raw', 'data.menon',
                 'data.dng', 'data.ljpeg', 'data.nikon', 'data.sony', 'data.camera_raw',
                 'cli.train_prepare_training_set', 'cli.develop_images',
                 'compression.baseline_jpeg', 'compression.jpeg_helpers',
                 'compression.ratedistortion', 'utils.image', 'cli.test_jpeg', 'cli.test_dcn',
                 'cli.test_dcn_rate_dist', 'parallel.mesh', 'parallel.multihost',
                 'parallel.train', 'parallel.launch', 'parallel.spatial', 'ops.hopper.registry',
                 'utils.profiling', 'utils.debugging', 'utils.runtime', 'utils.stats',
                 'utils.table', 'cli.test_nip', 'cli.diff_nip', 'cli.summarize_nip',
                 'cli.results', 'data.bmp', 'compression.jp2_helpers', 'compression.webp',
                 'compression.avif', 'compression.hevc', 'compression.bpg_helpers',
                 'cli.pstrace'):
        assert f'neural_imaging_tpu_torch.{name}' in modules
    code = '\n'.join([
        'import importlib, sys',
        f'for name in {BLOCKED!r}:',
        '    sys.modules[name] = None',
        f'for name in {modules!r}:',
        '    importlib.import_module(name)',
        f'leaked = [m for m in sys.modules if m.split(".")[0] in {BLOCKED!r} '
        'and sys.modules[m] is not None]',
        'assert not leaked, leaked',
        'print("imported", len(sys.modules))'])
    result = run_python(code)
    assert result.returncode == 0, result.stderr
    assert 'imported' in result.stdout


def test_chip_smoke_fails_without_a_gpu():
    result = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT, capture_output=True,
                            text=True, timeout=300,
                            env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout


@pytest.mark.parametrize('entry', [
    lambda: device_utils.resolve_device(),
    lambda: pipelines.INet(),
    lambda: forensics.FAN(n_classes=5),
    lambda: jpeg.JPEG(50),
    lambda: jpeg.DifferentiableJPEG(50),
    lambda: manipulation_classification.ManipulationClassification(raw_patch_size=16),
    lambda: compression.TwitterDCN(),
    lambda: base.restore('32c', compression),
    lambda: codec.restore('32c'),
    lambda: codec.compress(np.zeros((1, 16, 16, 3)), compression.TwitterDCN(patch_size=16)),
    # a stream header of a 1x1x32 latent: decoding it restores the 32c preset
    lambda: codec.decompress(bytes([1, 1, 32]) + np.uint16(64).tobytes()
                             + np.full(32, 1, np.uint16).tobytes()),
    lambda: pipelines.UNet(),
    lambda: pipelines.DNet(),
    lambda: pipelines.ClassicISP(),
    lambda: pipelines.ONet(),
    lambda: base.restore(os.path.join(ROOT, 'data/models/nip/QualityRef/UNet_5'), pipelines),
    lambda: manipulation_classification.ManipulationClassification(
        'ONet', raw_patch_size=16, distribution={'downsampling': 'none', 'compression': 'dcn',
                                                 'compression_params': {'dirname': '32c'}}),
    lambda: jpeg.JPEG(50, 'libjpeg'),
    lambda: ratedistortion.get_jpeg_df(ROOT),
    lambda: ratedistortion.get_dcn_df(ROOT, ROOT),
])
def test_entry_points_default_to_cuda_and_refuse_without_it(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        entry()


def test_cpu_is_taken_only_when_asked():
    assert device_utils.resolve_device('cpu') == torch.device('cpu')
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize('entry', ['sampler', 'cli', 'nip_cli', 'dcn_cli', 'dcn_channel_cli',
                                   'test_fan_cli', 'test_jpeg_cli', 'test_dcn_cli',
                                   'test_dcn_rate_dist_cli', 'test_nip_cli', 'diff_nip_cli'])
def test_trainer_entry_points_default_to_cuda_and_refuse_without_it(entry, tmp_path,
                                                                    monkeypatch):
    data_dir = fixtures.make_dataset(str(tmp_path / 'data'), n_images=2, height=64, width=96)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        if entry == 'sampler':
            DeviceSampler(Dataset(data_dir, n_images=1, v_images=1, val_rgb_patch_size=32), 1, 32)
        elif entry == 'cli':
            train_manipulation.main(['--nip', 'INet', '--data', data_dir, '--split', '1:1:1',
                                     '--patch', '16', '--batch', '1', '--dir',
                                     str(tmp_path / 'out')])
        elif entry == 'nip_cli':
            train_nip.main(['--nip', 'UNet', '--data', data_dir, '--split', '1:1:1',
                            '--patch', '16', '--batch', '1', '--out', str(tmp_path / 'out')])
        elif entry == 'dcn_cli':
            train_dcn.main(['--data', data_dir, '--split', '1:1:1', '--patch', '32',
                            '--batch', '1', '--out', str(tmp_path / 'out')])
        elif entry == 'dcn_channel_cli':
            train_manipulation.main(['--nip', 'ONet', '--dcn', '32c', '--data', data_dir,
                                     '--split', '1:1:1', '--patch', '16', '--batch', '1',
                                     '--dir', str(tmp_path / 'out')])
        elif entry == 'test_jpeg_cli':
            test_jpeg.main(['--dir', data_dir, '--images', '1'])
        elif entry == 'test_dcn_cli':
            test_dcn.main(['rate-dist', '--data', data_dir, '--images', '1', '--out',
                           str(tmp_path / 'out')])
        elif entry == 'test_dcn_rate_dist_cli':
            test_dcn_rate_dist.main(['--data', data_dir, '--out', str(tmp_path / 'out')])
        elif entry == 'test_nip_cli':
            test_nip.main(['--nip', 'INet', '--data', data_dir, '--images', '1', '--patch', '16',
                           '--out', str(tmp_path / 'out')])
        elif entry == 'diff_nip_cli':
            diff_nip.main(['--a', 'INet', '--data', data_dir, '--patch', '16', '--out',
                           str(tmp_path / 'out')])
        else:
            test_fan.main(['--run-dir', os.path.join(ROOT, 'data/m_quality/QualityRef/INet/'
                                                     'fixed-nip/fixed-codec/000'),
                           '--data', data_dir, '--patch', '16'])
    assert not (tmp_path / 'out').exists()
