"""The port's capture fixtures and its two RAW CLIs against the JAX
package's: ``simulate_sensor_mosaic``, ``make_dng_capture``,
``make_camera_capture`` and ``make_dng_dataset`` write the reference's
files byte for byte from the same ``image_rgb`` (the reference's
``real_photo`` patched to give that image, or None); the CLIs
``train_prepare_training_set`` and ``develop_images`` against the root
scripts (run in this process) on three DNG and three vendor captures:
``.npy`` identical, ``.png`` within ±1."""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu_torch.cli import develop_images, train_prepare_training_set
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.data.png import read_png
from neural_imaging_tpu_torch.ops.kernels import EXAMPLE_SRGB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFAS = ['RGGB', 'GBRG', 'BGGR', 'GRBG']


@pytest.fixture(scope='module')
def image():
    return fixtures.procedural_image(48, 80, 17)


def _same_bytes(a, b):
    return open(a, 'rb').read() == open(b, 'rb').read()


@pytest.mark.parametrize('cfa', CFAS)
def test_sensor_simulation_matches_the_reference(image, cfa):
    args = (image, cfa, (2.0, 1.0, 1.5, 1.0), EXAMPLE_SRGB, 512, 16383)
    np.testing.assert_array_equal(fixtures.simulate_sensor_mosaic(*args),
                                  jfixtures.simulate_sensor_mosaic(*args))


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('kind', ['dng', 'dng-ljpeg', 'cr2', 'nef', 'arw'])
def test_captures_are_the_reference_bytes(image, kind, cfa, tmp_path):
    ext = kind.split('-')[0]
    port, ref = str(tmp_path / f'p.{ext}'), str(tmp_path / f'r.{ext}')
    if ext == 'dng':
        compression = 'ljpeg' if kind.endswith('ljpeg') else 'none'
        fixtures.make_dng_capture(port, image_rgb=image, cfa_pattern=cfa, compression=compression)
        jfixtures.make_dng_capture(ref, image_rgb=image, cfa_pattern=cfa, compression=compression)
    else:
        fixtures.make_camera_capture(port, image_rgb=image, cfa_pattern=cfa)
        jfixtures.make_camera_capture(ref, image_rgb=image, cfa_pattern=cfa)
    assert _same_bytes(port, ref)


def test_captures_without_an_image_use_the_procedural_scene(tmp_path, monkeypatch):
    monkeypatch.setattr(jfixtures, 'real_photo', lambda: None)
    fixtures.make_dng_capture(str(tmp_path / 'p.dng'), seed=3)
    jfixtures.make_dng_capture(str(tmp_path / 'r.dng'), seed=3)
    assert _same_bytes(tmp_path / 'p.dng', tmp_path / 'r.dng')
    fixtures.make_camera_capture(str(tmp_path / 'p.x'), fmt='nef', seed=3)
    jfixtures.make_camera_capture(str(tmp_path / 'r.x'), fmt='nef', seed=3)
    assert _same_bytes(tmp_path / 'p.x', tmp_path / 'r.x')
    with pytest.raises(ValueError, match='container'):
        fixtures.make_camera_capture(str(tmp_path / 'p.raf'), image_rgb=np.zeros((4, 4, 3)))


@pytest.mark.parametrize('with_photo', [False, True])
def test_dng_dataset_matches_the_reference(with_photo, image, tmp_path, monkeypatch):
    photo = fixtures.procedural_image(400, 420, 5) if with_photo else None
    monkeypatch.setattr(jfixtures, 'real_photo', lambda: photo)
    port = fixtures.make_dng_dataset(str(tmp_path / 'p'), n_images=2, photo=photo)
    ref = jfixtures.make_dng_dataset(str(tmp_path / 'r'), n_images=2)
    assert [os.path.basename(p) for p in port] == [os.path.basename(r) for r in ref]
    for p, r in zip(port, ref):
        assert _same_bytes(p, r)


@pytest.mark.parametrize('noise', [None, (0.02, 0.01)])
def test_quality_dataset_matches_the_reference(noise, tmp_path, monkeypatch):
    """Photo crops (even images) and procedural scenes (odd), with and without
    the sensor noise that data/models/nip_noisy/QualityNoisy was trained on;
    targets developed with Menon on the CPU here."""
    photo = fixtures.procedural_image(60, 90, 8)
    monkeypatch.setattr(jfixtures, 'real_photo', lambda: photo)
    fixtures.make_quality_dataset(str(tmp_path / 'p'), n_images=3, height=32, width=48,
                                  noise=noise, photo=photo, device='cpu')
    jfixtures.make_quality_dataset(str(tmp_path / 'r'), n_images=3, height=32, width=48,
                                   noise=noise)
    names = sorted(os.listdir(tmp_path / 'r'))
    assert sorted(os.listdir(tmp_path / 'p')) == names and len(names) == 6
    for name in names:
        port, ref = str(tmp_path / 'p' / name), str(tmp_path / 'r' / name)
        if name.endswith('.npy'):
            np.testing.assert_array_equal(np.load(port), np.load(ref))
        else:
            assert np.abs(read_png(port).astype(int) - read_png(ref)).max() <= 1


# -- the CLIs against the root scripts ---------------------------------------------------

@pytest.fixture(scope='module')
def raw_dir(tmp_path_factory):
    """Three DNG captures (one lossless JPEG) and a CR2, a NEF and an ARW, 64x96."""
    d = tmp_path_factory.mktemp('raws')
    for i in range(3):
        fixtures.make_dng_capture(str(d / f'cap{i}.dng'),
                                  image_rgb=fixtures.procedural_image(64, 96, 10 + i),
                                  cfa_pattern='GBRG', compression='ljpeg' if i == 1 else 'none')
    for i, fmt in enumerate(('cr2', 'nef', 'arw')):
        fixtures.make_camera_capture(str(d / f'cam{i}.{fmt}'),
                                     image_rgb=fixtures.procedural_image(64, 96, 20 + i),
                                     cfa_pattern='GBRG')
    # a portrait capture: skipped by both scripts
    fixtures.make_dng_capture(str(d / 'tall.dng'), image_rgb=fixtures.procedural_image(96, 64, 9))
    return str(d)


def run_reference(script, argv, monkeypatch):
    """A root script of the JAX package, run in this process (CPU, no compile cache)."""
    monkeypatch.setenv('NI_TPU_CACHE_DIR', '0')
    monkeypatch.setattr(sys, 'argv', [script, *argv])
    runpy.run_path(os.path.join(ROOT, script), run_name='__main__')


def assert_same_outputs(port_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names and names
    for name in names:
        port, ref = os.path.join(port_dir, name), os.path.join(ref_dir, name)
        if name.endswith('.npy'):
            a, b = np.load(port), np.load(ref)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            a, b = read_png(port), read_png(ref)
            assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1, name
    return names


@pytest.mark.parametrize('dev', ['manual', 'auto'])
def test_prepare_training_set_matches_the_reference(dev, raw_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    run_reference('train_prepare_training_set.py',
                  ['--dir', raw_dir, '--out', str(tmp_path / 'ref'), '--dev', dev], monkeypatch)
    written = train_prepare_training_set.main(['--dir', raw_dir, '--out', str(tmp_path / 'port'),
                                               '--dev', dev, '--device', 'cpu'])
    names = assert_same_outputs(str(tmp_path / 'port'), str(tmp_path / 'ref'))
    assert len(names) == 12 and len(written) == 6 and 'tall.npy' not in names


def test_prepare_training_set_synthesizes_the_reference_pairs(tmp_path, monkeypatch):
    args = ['--synthesize', '2', '--height', '32', '--width', '48', '--seed', '7']
    run_reference('train_prepare_training_set.py', [*args, '--out', str(tmp_path / 'ref')],
                  monkeypatch)
    train_prepare_training_set.main([*args, '--out', str(tmp_path / 'port')])
    assert len(assert_same_outputs(str(tmp_path / 'port'), str(tmp_path / 'ref'))) == 4


@pytest.mark.parametrize('pipeline', ['manual', 'auto', 'INet', 'ClassicISP'])
def test_develop_images_matches_the_reference(pipeline, raw_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    args = ['--dir', raw_dir, '--pipeline', pipeline, '--cam', 'QualityRef']
    run_reference('develop_images.py', [*args, '--out', str(tmp_path / 'ref')], monkeypatch)
    written = develop_images.main([*args, '--out', str(tmp_path / 'port'), '--device', 'cpu'])
    names = assert_same_outputs(str(tmp_path / 'port'), str(tmp_path / 'ref'))
    assert len(names) == len(written) == 7
    assert all(n.endswith(f'_{pipeline}.png') for n in names)


def test_develop_images_takes_a_model_dir_and_develops_the_whole_stack(raw_dir, tmp_path):
    written = develop_images.main([
        '--dir', raw_dir, '--out', str(tmp_path), '--pipeline', 'UNet', '--device', 'cpu',
        '--model-dir', os.path.join(ROOT, 'data/models/nip/QualityRef/UNet_5/unet')])
    rgb = read_png(written[0])
    assert rgb.shape == (64, 96, 3) and rgb.dtype == np.uint8


@pytest.mark.parametrize('devices', ['auto', '2'])
def test_develop_images_refuses_spatial_sharding(devices, raw_dir, tmp_path, monkeypatch):
    """Spatial sharding (ported): ``--devices`` develops each image in row
    bands (2 here; 'auto' on the CPU is one band) and matches the root
    script's ``--devices`` run over the virtual devices (all 8 for 'auto')
    within ±1; more cards than the machine has are refused, and a
    non-neural pipeline ignores the flag."""
    monkeypatch.chdir(ROOT)
    args = ['--dir', raw_dir, '--pipeline', 'INet', '--cam', 'QualityRef', '--devices', devices]
    run_reference('develop_images.py', [*args, '--out', str(tmp_path / 'ref')], monkeypatch)
    written = develop_images.main([*args, '--out', str(tmp_path / 'port'), '--device', 'cpu'])
    assert len(assert_same_outputs(str(tmp_path / 'port'), str(tmp_path / 'ref'))) == \
        len(written) == 7
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f'asks for {n} CUDA devices'):
        develop_images.main(['--dir', raw_dir, '--out', str(tmp_path / 'o'), '--pipeline',
                             'UNet', '--devices', str(n), '--device', 'cuda'])
    assert not (tmp_path / 'o').exists()
    develop_images.main(['--dir', raw_dir, '--out', str(tmp_path / 'n'), '--pipeline',
                         'manual', '--devices', 'none', '--device', 'cpu'])


@pytest.mark.parametrize('cli', ['prepare', 'develop'])
def test_raw_clis_default_to_cuda_and_refuse_without_it(cli, raw_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        if cli == 'prepare':
            train_prepare_training_set.main(['--dir', raw_dir, '--out', str(tmp_path / 'o')])
        else:
            develop_images.main(['--dir', raw_dir, '--out', str(tmp_path / 'o')])
    assert not (tmp_path / 'o').exists()
