"""The port's baseline JPEG codec (``csrc/baseline_jpeg.cpp`` built with g++,
and its plain numpy/Python version) against libjpeg through PIL: the same
file bytes and the same decoded pixels, exactly, at every quality and
subsampling the reference uses; then the port's ``jpeg_helpers``, the
'libjpeg' ``JPEG`` codec and ``validate_jpeg`` against the JAX package's.
Tolerances: none (bytes and uint8 pixels equal) but where stated."""
import io

import numpy as np
import pytest
import torch
from PIL import Image

from neural_imaging_tpu.compression import jpeg_helpers as jhelpers
from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data.dataset import Dataset as JDataset
from neural_imaging_tpu.models import jpeg as jjpeg
from neural_imaging_tpu.training import validation as jvalidation
from neural_imaging_tpu_torch.compression import baseline_jpeg, jpeg_helpers
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.data.dataset import Dataset
from neural_imaging_tpu_torch.models import jpeg
from neural_imaging_tpu_torch.training import validation
from neural_imaging_tpu_torch.utils import native

QUALITIES = (1, 5, 10, 25, 50, 75, 90, 95, 100)
SUBSAMPLINGS = ('4:4:4', '4:2:2', '4:2:0')


def u8(image):
    return (np.clip(image, 0, 1) * 255).astype(np.uint8)


def seeded_images():
    """Seeded images at odd and even sizes, flat black and white, noise."""
    rng = np.random.default_rng(14)
    return {'proc_37x53': u8(fixtures.procedural_image(37, 53, 1)),
            'proc_64x96': u8(fixtures.procedural_image(64, 96, 2)),
            'proc_129x67': u8(fixtures.procedural_image(129, 67, 3)),
            'black_19x30': np.zeros((19, 30, 3), np.uint8),
            'white_30x19': np.full((30, 19, 3), 255, np.uint8),
            'noise_42x17': rng.integers(0, 256, (42, 17, 3)).astype(np.uint8),
            'noise_2x5': rng.integers(0, 256, (2, 5, 3)).astype(np.uint8)}


IMAGES = seeded_images()


def pil_jpeg(image, quality, subsampling, **options):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, 'JPEG', quality=quality,
                                subsampling=baseline_jpeg.SUBSAMPLING[subsampling], **options)
    data = buf.getvalue()
    return data, np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))


@pytest.mark.parametrize('subsampling', SUBSAMPLINGS)
@pytest.mark.parametrize('quality', QUALITIES)
def test_native_codec_gives_pils_bytes_and_pixels(quality, subsampling):
    for name, image in IMAGES.items():
        data, pixels = pil_jpeg(image, quality, subsampling)
        assert baseline_jpeg.encode(image, quality, subsampling) == data, name
        np.testing.assert_array_equal(baseline_jpeg.decode(data), pixels, err_msg=name)


@pytest.mark.parametrize('subsampling', SUBSAMPLINGS)
@pytest.mark.parametrize('quality', (5, 50, 100))
def test_plain_version_codes_as_the_native_codec(quality, subsampling):
    for name, image in IMAGES.items():
        data = baseline_jpeg.encode(image, quality, subsampling)
        assert baseline_jpeg.encode_plain(image, quality, subsampling) == data, name
        np.testing.assert_array_equal(baseline_jpeg.decode_plain(data),
                                      baseline_jpeg.decode(data), err_msg=name)


@pytest.mark.parametrize('options', [
    {'optimize': True}, {'optimize': True, 'subsampling': 2},
    {'restart_marker_blocks': 3}, {'restart_marker_rows': 1, 'subsampling': 2}],
    ids=['optimized', 'optimized-420', 'restart-blocks', 'restart-rows-420'])
def test_decoders_read_other_baseline_files(options):
    """Optimized Huffman tables and restart intervals, as PIL writes them."""
    image = IMAGES['proc_129x67']
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, 'JPEG', quality=70, **options)
    data = buf.getvalue()
    pixels = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
    np.testing.assert_array_equal(baseline_jpeg.decode(data), pixels)
    np.testing.assert_array_equal(baseline_jpeg.decode_plain(data), pixels)


@pytest.mark.parametrize('jfif', [True, False], ids=['jfif', 'no-jfif'])
@pytest.mark.parametrize('adobe', [None, 0, 1], ids=['no-adobe', 'adobe-rgb', 'adobe-ycc'])
def test_decoders_guess_the_color_space_as_libjpeg(jfif, adobe):
    """JFIF means YCbCr; without it Adobe's transform flag decides (0: RGB)."""
    data = pil_jpeg(IMAGES['proc_37x53'], 80, '4:4:4')[0]
    assert data[2:4] == b'\xff\xe0'
    body = data[2:] if jfif else data[4 + int.from_bytes(data[4:6], 'big'):]
    if adobe is not None:
        body = b'\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00' + bytes([adobe]) + body
    data = b'\xff\xd8' + body
    pixels = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
    np.testing.assert_array_equal(baseline_jpeg.decode(data), pixels)
    np.testing.assert_array_equal(baseline_jpeg.decode_plain(data), pixels)


def test_decoders_read_grayscale_and_refuse_progressive():
    buf = io.BytesIO()
    Image.fromarray(IMAGES['proc_64x96'][..., 1]).save(buf, 'JPEG', quality=80)
    gray = buf.getvalue()
    pixels = np.asarray(Image.open(io.BytesIO(gray)).convert('RGB'))
    np.testing.assert_array_equal(baseline_jpeg.decode(gray), pixels)
    np.testing.assert_array_equal(baseline_jpeg.decode_plain(gray), pixels)
    buf = io.BytesIO()
    Image.fromarray(IMAGES['proc_64x96']).save(buf, 'JPEG', progressive=True)
    for decode in (baseline_jpeg.decode, baseline_jpeg.decode_plain):
        with pytest.raises(NotImplementedError, match='Progressive'):
            decode(buf.getvalue())
    with pytest.raises(ValueError, match='SOI'):
        baseline_jpeg.decode(b'not a jpeg')


def test_committed_digests_are_pils():
    """``PIL_DIGESTS`` (what a machine without PIL checks the codec against)
    are libjpeg's files and decodes here, and both codecs reproduce them."""
    images = baseline_jpeg.digest_images()
    assert len(baseline_jpeg.PIL_DIGESTS) == 18
    for (name, quality, subsampling), (file_digest, pixel_digest) in \
            baseline_jpeg.PIL_DIGESTS.items():
        data, pixels = pil_jpeg(images[name], quality, subsampling)
        assert baseline_jpeg.sha256(data) == file_digest
        assert baseline_jpeg.sha256(np.ascontiguousarray(pixels)) == pixel_digest
    assert baseline_jpeg.digest_mismatches() == []
    assert baseline_jpeg.digest_mismatches(baseline_jpeg.encode_plain,
                                           baseline_jpeg.decode_plain) == []
    # a codec that is off by one sample is caught
    assert baseline_jpeg.digest_mismatches(
        lambda im, q, s: baseline_jpeg.encode(np.roll(im, 1, axis=1), q, s))


def test_quant_tables_are_libjpegs():
    for quality in QUALITIES:
        tables = jhelpers.JPEGMarkerStats(pil_jpeg(IMAGES['proc_64x96'], quality, '4:4:4')[0]) \
            .quantization_tables
        q = baseline_jpeg.quant_tables(quality)
        for t in (0, 1):
            np.testing.assert_array_equal(q[t].reshape(8, 8), tables[t])


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / 'baseline_jpeg.cpp'
    broken.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(baseline_jpeg, 'SOURCE', broken)
    with pytest.raises(RuntimeError, match='build failed'):
        baseline_jpeg.build()


def test_encode_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match='uint8'):
        baseline_jpeg.encode(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match='subsampling'):
        baseline_jpeg.encode(np.zeros((8, 8, 3), np.uint8), 50, '4:1:1')


@pytest.mark.parametrize('subsampling', SUBSAMPLINGS)
@pytest.mark.parametrize('effective', [False, True])
def test_compress_batch_matches_reference(effective, subsampling):
    batch = np.stack([fixtures.procedural_image(48, 64, s) for s in range(3)]).astype(np.float32)
    for quality in (20, 85):
        y, sizes = jpeg_helpers.compress_batch(batch, quality, effective, subsampling)
        y_ref, sizes_ref = jhelpers.compress_batch(batch, quality, effective, subsampling)
        assert sizes == sizes_ref and y.dtype == y_ref.dtype
        np.testing.assert_array_equal(y, y_ref)
    single, n = jpeg_helpers.compress_batch(255 * batch[0], 50)     # uint8 scale, one image
    single_ref, n_ref = jhelpers.compress_batch(255 * batch[0], 50)
    assert n == n_ref
    np.testing.assert_array_equal(single, single_ref)


@pytest.mark.parametrize('match,target', [('ssim', 0.9), ('ssim', 0.99), ('bpp', 1.0),
                                          ('bpp', 0.05), ('ssim', 0.2)])
def test_match_quality_matches_reference(match, target):
    image = fixtures.procedural_image(64, 96, 5).astype(np.float32)
    assert (jpeg_helpers.match_quality(image, target, match)
            == jhelpers.match_quality(image, target, match))


@pytest.mark.parametrize('subsampling', SUBSAMPLINGS)
def test_marker_stats_match_reference(subsampling):
    for name, image in IMAGES.items():
        data = baseline_jpeg.encode(image, 60, subsampling)
        stats, ref = jpeg_helpers.JPEGMarkerStats(data), jhelpers.JPEGMarkerStats(data)
        assert stats.blocks == ref.blocks and stats.shape == ref.shape, name
        assert stats.quantization_tables.keys() == ref.quantization_tables.keys()
        for k, table in ref.quantization_tables.items():
            np.testing.assert_array_equal(stats.quantization_tables[k], table)
        assert (stats.get_bytes(), stats.get_effective_bytes()) == \
            (ref.get_bytes(), ref.get_effective_bytes())
        assert (stats.get_bpp(), stats.get_effective_bpp()) == \
            (ref.get_bpp(), ref.get_effective_bpp())
    np.testing.assert_array_equal(jpeg_helpers.zigzag(8), jhelpers.zigzag(8))


def test_marker_stats_read_a_file_and_refuse_progressive(tmp_path):
    path = tmp_path / 'a.jpg'
    path.write_bytes(pil_jpeg(IMAGES['proc_37x53'], 50, '4:2:0')[0])
    assert jpeg_helpers.JPEGMarkerStats(str(path)).shape == (37, 53, 3)
    buf = io.BytesIO()
    Image.fromarray(IMAGES['proc_37x53']).save(buf, 'JPEG', progressive=True)
    with pytest.raises(NotImplementedError, match='Progressive'):
        jpeg_helpers.JPEGMarkerStats(buf.getvalue())


def test_libjpeg_codec_matches_reference():
    x = np.stack([fixtures.procedural_image(32, 48, s) for s in (7, 8)]).astype(np.float32)
    codec = jpeg.JPEG(50, 'libjpeg', device='cpu')
    ref = jjpeg.JPEG(50, 'libjpeg')
    assert codec._model is None and repr(codec) == repr(ref)
    assert codec.summary() == ref.summary() and codec.model_code == ref.model_code
    np.testing.assert_array_equal(codec.process(x), ref.process(x))
    np.testing.assert_array_equal(codec.process(torch.from_numpy(x), 80), ref.process(x, 80))
    y, entropy = codec.process(x, return_entropy=True)
    assert np.isnan(entropy) and isinstance(y, np.ndarray)
    with pytest.raises(ValueError, match='no differentiable parameters'):
        codec.process_with_params(x, {})
    assert codec.count_parameters() == 0 and codec.checkpoint() == {}
    # a quality range draws from the generator as the reference's does
    ranged = jpeg.JPEG((30, 90), 'libjpeg', rng=np.random.default_rng(3), device='cpu')
    ranged_ref = jjpeg.JPEG((30, 90), 'libjpeg', rng=np.random.default_rng(3))
    for _ in range(3):
        np.testing.assert_array_equal(ranged.process(x), ranged_ref.process(x))


def test_validate_jpeg_with_libjpeg_matches_reference(tmp_path):
    """``validate_jpeg`` of a libjpeg codec: SSIM and PSNR equal to 1e-12
    (the same decoded pixels, the same float64 metrics), entropy NaN."""
    data_dir = str(tmp_path / 'rgb')
    jfixtures.make_dataset(data_dir, n_images=4, height=64, width=96, rgb_only=True)
    port = Dataset(data_dir, n_images=2, v_images=2, load='y', val_rgb_patch_size=32)
    ref = JDataset(data_dir, n_images=2, v_images=2, load='y', val_rgb_patch_size=32)
    got = validation.validate_jpeg(jpeg.JPEG(60, 'libjpeg', device='cpu'), port, batch_size=1)
    want = jvalidation.validate_jpeg(jjpeg.JPEG(60, 'libjpeg'), ref, batch_size=1)
    assert np.isnan(got['entropy']) and np.isnan(want['entropy'])
    for key in ('ssim', 'psnr'):
        assert abs(got[key] - want[key]) <= 1e-12
