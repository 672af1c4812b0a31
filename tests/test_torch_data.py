"""The port's data layer against the JAX package's, on the CPU: PNG without
PIL, the procedural fixtures, the patch-sampling Dataset, the host metrics,
the host prefetcher and the device sampler.

Equalities are exact (the same arrays, bit for bit) except the metrics,
held to 1e-12, where both packages run the same float64 code."""
import os
import struct
import threading
import time
import zlib

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from neural_imaging_tpu.data import dataset as jdataset
from neural_imaging_tpu.data import device_sampler as jsampler
from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data import loading as jloading
from neural_imaging_tpu.data import raw as jraw
from neural_imaging_tpu.utils import metrics as jmetrics
from neural_imaging_tpu_torch.data import fixtures, loading, png, raw
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.data.device_sampler import DeviceSampler
from neural_imaging_tpu_torch.data.prefetch import EpochPrefetcher, prefetch
from neural_imaging_tpu_torch.utils import metrics

torch.set_num_threads(1)

HEIGHT, WIDTH = 64, 96
SPLIT = dict(n_images=4, v_images=2, val_rgb_patch_size=32, val_n_patches=2)


def image(seed, channels):
    """A procedural uint8 image with `channels` channels (1 → (h, w))."""
    rgb = (jfixtures.procedural_image(HEIGHT, WIDTH, seed) * 255).round().astype(np.uint8)
    if channels == 1:
        return rgb[..., 0]
    if channels == 4:
        alpha = np.random.default_rng(seed).integers(0, 256, (HEIGHT, WIDTH, 1), dtype=np.uint8)
        return np.concatenate([rgb, alpha], axis=-1)
    return rgb


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(filename, pixels, filters):
    """A PNG of uint8 `pixels` whose row y is filtered with filters[y % len]
    (the filters applied forward, as a PNG encoder does)."""
    h = pixels.shape[0]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = pixels.reshape(h, -1).astype(np.int64)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        kind, row = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(channels, np.int64), row[:-channels]])
        upleft = np.concatenate([np.zeros(channels, np.int64), prev[:-channels]])
        pred = [0, left, prev, (left + prev) // 2, paeth(left, prev, upleft)][kind]
        out.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
        prev = row
    colour = {1: 0, 3: 2, 4: 6}[channels]
    ihdr = struct.pack('>IIBBBBB', pixels.shape[1], h, 8, colour, 0, 0, 0)
    with open(filename, 'wb') as f:
        f.write(png.SIGNATURE + png._chunk(b'IHDR', ihdr)
                + png._chunk(b'IDAT', zlib.compress(np.concatenate(out).tobytes()))
                + png._chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_read_png_reads_what_imageio_wrote(tmp_path, channels):
    """imageio (Pillow) writes adaptive filters: Sub, Up and Paeth rows."""
    pixels = image(channels, channels)
    filename = str(tmp_path / 'x.png')
    imageio.imwrite(filename, pixels)
    out = png.read_png(filename)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, imageio.imread(filename))
    np.testing.assert_array_equal(out, pixels)


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4], [4, 3, 0, 1, 2]],
                         ids=['none', 'sub', 'up', 'average', 'paeth', 'mixed'])
def test_read_png_undoes_every_row_filter(tmp_path, channels, filters):
    pixels = image(10 + channels, channels)
    filename = str(tmp_path / 'x.png')
    encode_png(filename, pixels, filters)
    np.testing.assert_array_equal(imageio.imread(filename), pixels)
    np.testing.assert_array_equal(png.read_png(filename), pixels)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_imageio_reads_what_write_png_wrote(tmp_path, channels):
    pixels = image(20 + channels, channels)
    filename = str(tmp_path / 'x.png')
    png.write_png(filename, pixels)
    np.testing.assert_array_equal(imageio.imread(filename), pixels)
    np.testing.assert_array_equal(png.read_png(filename), pixels)


@pytest.mark.parametrize('header, message', [
    ((8, 8, 8, 3, 0, 0, 0), 'colour type 3'),       # palette
    ((8, 8, 16, 2, 0, 0, 0), 'bit depth 16'),
    ((8, 8, 8, 4, 0, 0, 0), 'colour type 4'),       # gray with alpha
    ((8, 8, 8, 2, 0, 0, 1), 'interlaced'),
], ids=['palette', '16-bit', 'gray-alpha', 'adam7'])
def test_read_png_refuses_what_it_does_not_cover(tmp_path, header, message):
    filename = str(tmp_path / 'x.png')
    with open(filename, 'wb') as f:
        f.write(png.SIGNATURE + png._chunk(b'IHDR', struct.pack('>IIBBBBB', *header))
                + png._chunk(b'IDAT', zlib.compress(bytes(8 * 25))) + png._chunk(b'IEND', b''))
    with pytest.raises(ValueError, match=message):
        png.read_png(filename)


def test_read_png_refuses_a_corrupt_chunk(tmp_path):
    filename = str(tmp_path / 'x.png')
    png.write_png(filename, image(1, 3))
    blob = bytearray(open(filename, 'rb').read())
    blob[40] ^= 0xFF
    open(filename, 'wb').write(bytes(blob))
    with pytest.raises(ValueError, match='CRC'):
        png.read_png(filename)


# -- fixtures -----------------------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 7, 1234])
def test_fixtures_match_the_reference(seed):
    np.testing.assert_array_equal(fixtures.procedural_image(HEIGHT, WIDTH, seed),
                                  jfixtures.procedural_image(HEIGHT, WIDTH, seed))
    stack, rgb = fixtures.make_raw_rgb_pair(HEIGHT, WIDTH, seed)
    ref_stack, ref_rgb = jfixtures.make_raw_rgb_pair(HEIGHT, WIDTH, seed)
    assert stack.dtype == np.uint16 and rgb.dtype == np.uint8
    np.testing.assert_array_equal(stack, ref_stack)
    np.testing.assert_array_equal(rgb, ref_rgb)


@pytest.mark.parametrize('seed', [0, 7, 1234])
def test_make_dataset_matches_the_reference(tmp_path, seed):
    fixtures.make_dataset(str(tmp_path / 'port'), n_images=2, height=HEIGHT, width=WIDTH,
                          seed=seed)
    jfixtures.make_dataset(str(tmp_path / 'ref'), n_images=2, height=HEIGHT, width=WIDTH,
                           seed=seed)
    names = sorted(os.listdir(tmp_path / 'ref'))
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        port, ref = str(tmp_path / 'port' / name), str(tmp_path / 'ref' / name)
        if name.endswith('.npy'):
            np.testing.assert_array_equal(np.load(port), np.load(ref))
        else:
            np.testing.assert_array_equal(imageio.imread(port), imageio.imread(ref))


@pytest.mark.parametrize('cfa', ['GBRG', 'RGGB', 'BGGR', 'GRBG'])
def test_develop_mosaic_matches_the_reference(cfa):
    mosaic = np.random.default_rng(3).random((HEIGHT, WIDTH))
    np.testing.assert_array_equal(
        raw.develop_mosaic(mosaic, cfa, cam2srgb=np.eye(3) * 1.1, brightness='shift'),
        jraw.develop_mosaic(mosaic, cfa, cam2srgb=np.eye(3) * 1.1, brightness='shift'))


@pytest.mark.parametrize('demosaicing', ['menon', 'malvar'])
def test_unported_demosaicing_raises(demosaicing):
    """Malvar and Menon were refused here until the port had them; now they
    develop as the reference does (tests/test_torch_raw_develop.py holds
    them to it), and a demosaicer neither package has raises."""
    mosaic = np.random.default_rng(4).random((HEIGHT, WIDTH))
    assert np.abs(raw.develop_mosaic(mosaic, 'GBRG', demosaicing=demosaicing)
                  - jraw.develop_mosaic(mosaic, 'GBRG', demosaicing=demosaicing)).max() <= 1e-12
    with pytest.raises(ValueError, match='demosaicing'):
        raw.develop_mosaic(np.zeros((8, 8)), 'GBRG', demosaicing=demosaicing + '2')


# -- loading and the dataset ------------------------------------------------------------

@pytest.fixture(scope='module')
def data_dir(tmp_path_factory):
    """Six pairs written by the JAX package (imageio PNGs, Paeth rows)."""
    return jfixtures.make_dataset(str(tmp_path_factory.mktemp('data')), n_images=6,
                                  height=HEIGHT, width=WIDTH, seed=500)


@pytest.mark.parametrize('discard', [None, 'flat', 'flat-aggressive', 'dark-n-textured'])
def test_sample_patch_matches_the_reference(discard):
    rgb = image(5, 3)
    rng, ref_rng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        assert (loading.sample_patch(rgb, 32, discard, rng=rng)
                == jloading.sample_patch(rgb, 32, discard, rng=ref_rng))


@pytest.mark.parametrize('load', ['xy', 'y'])
def test_dataset_draws_the_reference_batches(data_dir, load):
    port = Dataset(data_dir, load=load, **SPLIT)
    ref = jdataset.Dataset(data_dir, load=load, **SPLIT)
    assert port.files == ref.files
    for k in load:
        np.testing.assert_array_equal(port.data['validation'][k], ref.data['validation'][k])
        np.testing.assert_array_equal(port.data['training'][k], ref.data['training'][k])
    for attr in ('summary', 'details', '__repr__', 'shapes', 'is_raw_and_rgb'):
        assert getattr(port, attr)() == getattr(ref, attr)()
    assert (port.count_training, port.count_validation, port.rgb_patch_size, port.loaded_data) \
        == (ref.count_training, ref.count_validation, ref.rgb_patch_size, ref.loaded_data)
    for i in range(8):
        quantized = i % 2 == 1
        batch = port.next_training_batch(i % 2, 2, 32, quantized=quantized)
        ref_batch = ref.next_training_batch(i % 2, 2, 32, quantized=quantized)
        for a, b in zip(batch if load == 'xy' else [batch], ref_batch if load == 'xy'
                        else [ref_batch]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    validation = port.next_validation_batch(1, 2)
    for a, b in zip(validation if load == 'xy' else [validation],
                    ref.next_validation_batch(1, 2) if load == 'xy'
                    else [ref.next_validation_batch(1, 2)]):
        np.testing.assert_array_equal(a, b)


def test_validation_tensors_hold_the_validation_batch(data_dir):
    port = Dataset(data_dir, **SPLIT)
    x, y = port.validation_tensors('cpu')
    ref_x, ref_y = port.next_validation_batch(0, port.count_validation)
    np.testing.assert_array_equal(x.numpy(), ref_x)
    np.testing.assert_array_equal(y.numpy(), ref_y)


def test_dataset_finds_a_named_directory_and_refuses_a_missing_one(tmp_path):
    with pytest.raises(ValueError, match='Cannot find'):
        Dataset(str(tmp_path / 'missing'))
    with pytest.raises(ValueError, match='Cannot find'):
        Dataset('no-such-camera')


def test_prefetcher_yields_the_generator_batches(data_dir):
    port, ref = Dataset(data_dir, **SPLIT), Dataset(data_dir, **SPLIT)
    prefetcher = EpochPrefetcher(port, 2, 32, 'cpu')
    for epoch in range(2):
        expected = list(ref.get_training_generator(2, 32, 'flat', quantized=True))
        got = list(prefetcher)
        assert len(got) == len(expected) == 2
        for (x, y), (ref_x, ref_y) in zip(got, expected):
            assert x.dtype == torch.uint16 and y.dtype == torch.uint8
            np.testing.assert_array_equal(x.numpy(), ref_x)
            np.testing.assert_array_equal(y.numpy(), ref_y)


def test_prefetch_raises_the_producer_error():
    def batches():
        yield np.zeros(3, np.float32)
        raise KeyError('producer failed')

    out = prefetch(batches(), torch.device('cpu'))
    assert next(out).shape == (3,)
    with pytest.raises(KeyError, match='producer failed'):
        next(out)



def leave_after_one_batch(how):
    for _ in prefetch(endless_batches(), torch.device('cpu'), size=1):
        if how == 'raise':
            raise ValueError('step failed')
        break


def endless_batches():
    while True:
        yield np.zeros(3, np.float32)


@pytest.mark.parametrize('how', ['break', 'raise'])
def test_prefetch_stops_its_producer_when_the_consumer_stops(how):
    """A consumer that leaves after one batch, while the producer waits on a
    full queue, returns at once and leaves no producer thread behind."""
    before = set(threading.enumerate())
    t0 = time.perf_counter()
    if how == 'raise':
        with pytest.raises(ValueError, match='step failed'):
            leave_after_one_batch(how)
    else:
        leave_after_one_batch(how)
    assert time.perf_counter() - t0 < 5
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]

# -- metrics --------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['ssim', 'psnr', 'mse', 'mae'])
def test_metrics_match_the_reference(name):
    rng = np.random.default_rng(4)
    a = rng.random((3, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    port, ref = getattr(metrics, name), getattr(jmetrics, name)
    np.testing.assert_allclose(port(a, b), ref(a, b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port(a[0], b[0]), ref(a[0], b[0]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(metrics.batch(a, b, port), jmetrics.batch(a, b, ref),
                               rtol=1e-12, atol=1e-12)


# -- the device sampler -------------------------------------------------------------------

def write_pairs(directory, rgbs):
    """A dataset directory of given uint8 RGB images and RAW stacks whose
    entries hold the RGB of their top-left pixel of each 2x2 tile x 256."""
    os.makedirs(directory, exist_ok=True)
    for i, rgb in enumerate(rgbs):
        png.write_png(os.path.join(directory, f'img_{i:04d}.png'), rgb)
        stack = rgb[::2, ::2].astype(np.uint16) * 256
        np.save(os.path.join(directory, f'img_{i:04d}.npy'),
                np.concatenate([stack, stack[..., :1] + 1], axis=-1))
    return directory


@pytest.fixture(scope='module')
def coordinate_data(tmp_path_factory):
    """Images that encode their own index and coordinates: RGB (i, y, x)."""
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    rgbs = [np.stack([np.full_like(yy, 40 * i), yy, xx], axis=-1).astype(np.uint8)
            for i in range(4)]
    return Dataset(write_pairs(str(tmp_path_factory.mktemp('coords')), rgbs),
                   n_images=4, v_images=0, val_n_patches=0)


@pytest.fixture(scope='module')
def flat_data(tmp_path_factory):
    """Two textured images and two equal flat ones, whose candidates tie on
    their variance (exactly 0 in the port; the reference's float32 variance
    of a flat patch is a rounding residue, the same for patches of one value)."""
    flat = np.full((HEIGHT, WIDTH, 3), 90, np.uint8)
    rgbs = [image(30, 3), flat, image(31, 3), flat]
    return Dataset(write_pairs(str(tmp_path_factory.mktemp('flat')), rgbs),
                   n_images=4, v_images=0, val_n_patches=0)


def reference_draws(sampler, step):
    """The candidate draws of the JAX sampler's step, as its sample function makes them."""
    key = jax.random.fold_in(sampler._key, step)
    k_i, k_y, k_x, k_u = jax.random.split(key, 4)
    M, P = sampler.batch_size * sampler.oversample, sampler.rgb_patch_size
    idx = jax.random.randint(k_i, (M,), 0, sampler.n_images)
    yy = 2 * jax.random.randint(k_y, (M,), 0, (sampler.H - P) // 2 + 1)
    xx = 2 * jax.random.randint(k_x, (M,), 0, (sampler.W - P) // 2 + 1)
    u = jax.random.uniform(k_u, (M,))
    return [torch.from_numpy(np.array(a)) for a in (idx, yy, xx, u)]


@pytest.mark.parametrize('dataset', ['coordinate_data', 'flat_data'])
@pytest.mark.parametrize('batch', [2, 3])
def test_sampler_keeps_the_reference_patches(request, dataset, batch):
    data = request.getfixturevalue(dataset)
    port = DeviceSampler(data, batch, 32, device='cpu')
    ref = jsampler.DeviceSampler(data, batch, 32)
    for step in range(6):
        draws = reference_draws(ref, step)
        raw, rgb = port.sample(*draws)
        ref_raw, ref_rgb = ref(step)
        assert raw.dtype == torch.uint16 and rgb.dtype == torch.uint8
        np.testing.assert_array_equal(raw.numpy(), np.asarray(ref_raw))
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(ref_rgb))


def test_sampler_patches_are_aligned_and_even(coordinate_data):
    sampler = DeviceSampler(coordinate_data, 4, 32, device='cpu')
    for step in range(5):
        raw, rgb = sampler(step)
        rgb, raw = rgb.numpy().astype(np.int64), raw.numpy().astype(np.int64)
        yy, xx = rgb[:, 0, 0, 1], rgb[:, 0, 0, 2]
        assert (yy % 2 == 0).all() and (xx % 2 == 0).all()
        assert rgb.shape == (4, 32, 32, 3) and raw.shape == (4, 16, 16, 4)
        # the RAW patch starts at the RGB patch's tile: same image, half coordinates
        np.testing.assert_array_equal(raw[:, 0, 0, :3] // 256, rgb[:, 0, 0])
        np.testing.assert_array_equal(raw[:, 1, 1, 1] // 256, yy + 2)


def test_sampler_is_deterministic_in_seed_and_step(coordinate_data):
    a = DeviceSampler(coordinate_data, 4, 32, seed=3, device='cpu')
    b = DeviceSampler(coordinate_data, 4, 32, seed=3, device='cpu')
    c = DeviceSampler(coordinate_data, 4, 32, seed=4, device='cpu')
    first = a(5)
    a(6)
    for x, y in zip(first, b(5)):
        assert torch.equal(x, y)
    for x, y in zip(a(5), first):
        assert torch.equal(x, y)
    assert not torch.equal(a(6)[1], first[1])
    assert not torch.equal(c(5)[1], first[1])
    assert a.epoch_steps() == 1 and a.signature() == b.signature()
