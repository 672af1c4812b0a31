"""The port's codec-evaluation CLIs (``cli/test_jpeg.py``, ``cli/test_dcn.py``
in its four modes, ``cli/test_dcn_rate_dist.py``) on the CPU at a tiny size,
against the numbers the JAX package's functions give for the same images.

Tolerances: libjpeg's numbers (bytes, qualities, SSIM, PSNR) equal to 1e-9;
dJPEG's PSNR within 1e-3 dB (K1's plain version against the reference's
float32 JPEG, pixels within 2e-6); the DCN's bytes equal and its SSIM and
PSNR within 1e-6 and 1e-4 dB (one bitstream, two float32 decoders); the
fitted curves within 1e-6."""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pandas as pd
import pytest

from neural_imaging_tpu.compression import codec as jcodec
from neural_imaging_tpu.compression import jpeg_helpers as jhelpers
from neural_imaging_tpu.compression import ratedistortion as jrd
from neural_imaging_tpu.data import loading as jloading
from neural_imaging_tpu.models import jpeg as jjpeg
from neural_imaging_tpu.utils import metrics as jmetrics
from neural_imaging_tpu_torch.cli import test_dcn, test_dcn_rate_dist, test_jpeg
from neural_imaging_tpu_torch.compression import ratedistortion as rd
from neural_imaging_tpu_torch.data import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCN_8C = os.path.join(ROOT, 'data/models/dcn/baselines/8c')
LIBJPEG_TOL, DJPEG_PSNR_TOL, DCN_SSIM_TOL, DCN_PSNR_TOL, FIT_TOL = 1e-9, 1e-3, 1e-6, 1e-4, 1e-6


@pytest.fixture(scope='module')
def image_dir(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('images'))
    for i in range(2):
        image = (fixtures.procedural_image(64, 96, 60 + i) * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(directory, f'im_{i}.png'), image)
    return directory


def reference_batch(directory, n):
    """The root CLIs' batch: the first n images, cropped to multiples of 8."""
    files, _ = jloading.discover_images(directory, n_images=-1, v_images=0)
    batch = jloading.load_images(files[:n], directory, load='y')['y'].astype(np.float32) / 255
    return batch[:, :(batch.shape[1] // 8) * 8, :(batch.shape[2] // 8) * 8]


def test_test_jpeg_matches_reference(image_dir, capsys):
    rows = test_jpeg.main(['--dir', image_dir, '--images', '2', '--qmin', '30', '--qmax', '90',
                           '--step', '30', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert out.count('QF ') == 3 and out.count('figure: not written') == 1
    batch = reference_batch(image_dir, 2)
    np.testing.assert_array_equal(test_jpeg.load_batch(image_dir, 2), batch)
    codec = jjpeg.JPEG(50, 'soft')
    assert [r[0] for r in rows] == [30, 60, 90]
    for qf, psnr_soft, psnr_hard in rows:
        soft = np.asarray(codec.process(batch, qf))
        hard, _ = jhelpers.compress_batch(batch, qf)
        assert abs(psnr_soft - float(np.mean(jmetrics.psnr(batch, soft)))) <= DJPEG_PSNR_TOL
        assert abs(psnr_hard - float(np.mean(jmetrics.psnr(batch, hard)))) <= LIBJPEG_TOL


def test_test_jpeg_defaults_to_the_procedural_batch():
    batch = test_jpeg.load_batch(None, 2)
    from neural_imaging_tpu.data import fixtures as jfixtures
    np.testing.assert_array_equal(batch, jfixtures.kodak_like_batch(2, 256, 384))


@pytest.fixture(scope='module')
def reference_dcn(image_dir):
    """The JAX package's 8c round trip of each image: (images, decodes, bytes)."""
    dcn = jcodec.restore(DCN_8C)
    batch = reference_batch(image_dir, 2)
    results = [jcodec.simulate_compression(img[None], dcn) for img in batch]
    return dcn, batch, [r[0][0] for r in results], [r[1] for r in results]


def run_test_dcn(mode, image_dir, *extra):
    return test_dcn.main([mode, '--dcn', DCN_8C, '--data', image_dir, '--images', '2',
                          '--device', 'cpu', *extra])


def test_test_dcn_batch_mode_matches_reference(image_dir, reference_dcn, capsys):
    dcn, batch, _, _ = reference_dcn
    stats = run_test_dcn('batch', image_dir)
    assert 'latent entropy H=' in capsys.readouterr().out
    _, ref = jcodec.compress_n_stats(batch, dcn)
    np.testing.assert_array_equal(stats['bytes'], ref['bytes'])
    np.testing.assert_allclose(stats['ssim'], ref['ssim'], rtol=0, atol=DCN_SSIM_TOL)
    np.testing.assert_allclose(stats['psnr'], ref['psnr'], rtol=0, atol=DCN_PSNR_TOL)
    np.testing.assert_allclose(stats['entropy'], ref['entropy'], rtol=1e-6)


@pytest.mark.parametrize('match', ['ssim', 'bpp'])
def test_test_dcn_jpeg_match_matches_reference(image_dir, reference_dcn, match):
    _, batch, decodes, sizes = reference_dcn
    rows = run_test_dcn(f'jpeg-match-{match}', image_dir)
    assert len(rows) == 2
    for (i, dcn_ssim, dcn_bpp, qf, j_ssim, j_bpp), img, y, n in zip(rows, batch, decodes, sizes):
        h, w = img.shape[:2]
        ref_ssim = jmetrics.ssim(img, y)
        assert abs(dcn_ssim - ref_ssim) <= DCN_SSIM_TOL and dcn_bpp == 8 * n / (h * w)
        ref_qf = jhelpers.match_quality(img, target=ref_ssim if match == 'ssim' else dcn_bpp,
                                        match=match)
        assert qf == ref_qf
        jimg, jbytes = jhelpers.compress_batch(img, qf)
        assert abs(j_ssim - jmetrics.ssim(img, jimg)) <= LIBJPEG_TOL
        assert j_bpp == 8 * jbytes / (h * w)


def test_test_dcn_rate_dist_mode_matches_reference(image_dir, reference_dcn, tmp_path):
    dcn, batch, decodes, sizes = reference_dcn
    out = str(tmp_path / 'rd.csv')
    table = run_test_dcn('rate-dist', image_dir, '--out', out)
    df = pd.read_csv(out)
    assert list(df.columns) == ['image_id', 'codec', 'ssim', 'psnr', 'bpp']
    assert list(df['codec']) == [dcn.model_code] * 2 == list(table['codec'])
    for i, (img, y, n) in enumerate(zip(batch, decodes, sizes)):
        assert abs(table['ssim'][i] - jmetrics.ssim(img, y)) <= DCN_SSIM_TOL
        assert abs(table['psnr'][i] - jmetrics.psnr(img, y)) <= DCN_PSNR_TOL
        assert table['bpp'][i] == 8 * n / (img.shape[0] * img.shape[1])


def test_test_dcn_rate_dist_cli_matches_reference(image_dir, tmp_path, capsys):
    port_dir, ref_dir = str(tmp_path / 'port'), str(tmp_path / 'ref')
    shutil.copytree(image_dir, port_dir)
    shutil.copytree(image_dir, ref_dir)
    out = str(tmp_path / 'curves.csv')
    tables, curves = test_dcn_rate_dist.main(['--data', port_dir, '--dcn-models', DCN_8C,
                                              '--out', out, '--device', 'cpu'])
    printed = capsys.readouterr().out
    # every leg of the reference in its order, BPG only where bpgenc/bpgdec are
    # on PATH (its reason printed in place of rows otherwise)
    libraries = rd.codec_libraries()
    assert printed.startswith('codec libraries: libopenjp2 ')
    legs = [('JPEG', 'jpeg', 2 * 18), ('JPEG 2000', 'jpeg2000', 2 * 21), ('BPG', 'bpg', 2 * 11),
            ('WebP', 'webp', 2 * 18), ('AVIF', 'avif', 2 * 18)]
    if not libraries['bpgenc/bpgdec'][0]:
        assert 'BPG: no rows, bpgenc/bpgdec: bpgenc/bpgdec binaries not on PATH' in printed
        legs.remove(('BPG', 'bpg', 2 * 11))
    for leg, _, rows in legs:
        assert f'{leg}: {rows} rows' in printed
    assert [len(t) for t in tables] == [rows for _, _, rows in legs] + [2]
    for _, name, _ in legs:
        assert os.path.isfile(os.path.join(port_dir, f'{name}.csv'))
    assert os.path.isfile(os.path.join(port_dir, 'dcn.csv'))
    ref_table = jrd.get_jpeg_df(ref_dir)
    grid, fitted = jrd.fit_rd_curve_per_image(ref_table, 'ssim')
    (codec, image_id, got_grid, got_fitted), = [c for c in curves if c[0] == 'jpeg']
    assert image_id is None
    np.testing.assert_allclose(got_grid, grid, rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(got_fitted, fitted, rtol=0, atol=FIT_TOL)
    # one sample an image: the DCN codec has no fit and says so
    assert 'TwitterDCN-8C/soft-codebook_Q-5bpf_S+_H+250.00: no ssim fit' in printed
    written = pd.read_csv(out)
    assert list(written.columns) == ['codec', 'image_id', 'bpp', 'ssim']
    assert len(written) == 50 * len(legs)
    # --bulk: one pooled fit an image, from the cache
    _, bulk = test_dcn_rate_dist.main(['--data', port_dir, '--dcn-models', DCN_8C, '--bulk',
                                       '--metric', 'psnr', '--device', 'cpu'])
    assert [(c, i) for c, i, _, _ in bulk] == [(name, i) for _, name, _ in legs for i in (0, 1)]
