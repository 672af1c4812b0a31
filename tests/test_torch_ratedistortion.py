"""The port's rate-distortion layer (``compression/ratedistortion.py``)
against the JAX package's on one directory of procedural PNGs: the JPEG leg
and the 8c DCN leg row by row, the CSV cache read across packages, and the
curve fits on the same table.

Tolerances: bytes and bpp equal; on the JPEG leg SSIM and PSNR within 1e-9
(the same decoded pixels through the same float64 metrics); on the DCN leg
SSIM and PSNR within 1e-6 (the same bytes decoded by two float32 decoders);
the MS-SSIM values (float32 in both; the tables hold them in dB) within
1e-5; the fits within 1e-9 of the reference's on the same samples."""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pandas as pd
import pytest

from neural_imaging_tpu.compression import ratedistortion as jrd
from neural_imaging_tpu_torch.compression import ratedistortion as rd
from neural_imaging_tpu_torch.data import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DCN_8C = os.path.join(ROOT, 'data/models/dcn/baselines/8c')
QUALITIES = range(10, 96, 15)
EXACT = ('image_id', 'filename', 'codec', 'bytes', 'bpp')


def write_images(directory, n=2, height=96, width=128):
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        image = (fixtures.procedural_image(height, width, 40 + i) * 255).astype(np.uint8)
        imageio.imwrite(os.path.join(directory, f'img_{i}.png'), image)
    return directory


@pytest.fixture(scope='module')
def sweeps(tmp_path_factory):
    """Both packages' JPEG and DCN legs on the same images, each in its own
    copy of the directory (so that neither reads the other's cache)."""
    port_dir = write_images(str(tmp_path_factory.mktemp('port')))
    ref_dir = str(tmp_path_factory.mktemp('ref'))
    shutil.rmtree(ref_dir)
    shutil.copytree(port_dir, ref_dir)
    return {'dirs': (port_dir, ref_dir),
            'jpeg': (rd.get_jpeg_df(port_dir, qualities=QUALITIES, device='cpu'),
                     jrd.get_jpeg_df(ref_dir, qualities=QUALITIES)),
            'dcn': (rd.get_dcn_df(port_dir, DCN_8C, device='cpu'),
                    jrd.get_dcn_df(ref_dir, DCN_8C))}


def assert_rows_match(table, df, metric_tol):
    assert table.columns == list(df.columns) == rd.RD_COLUMNS
    assert len(table) == len(df) > 0
    for column in EXACT:
        assert list(table[column]) == list(df[column]), column
    np.testing.assert_array_equal(np.isnan(table['quality'].astype(float)),
                                  np.isnan(df['quality'].astype(float)))
    for column in ('ssim', 'psnr'):
        np.testing.assert_allclose(table[column].astype(float), df[column].values, rtol=0,
                                   atol=metric_tol)
    # the MS-SSIM values, 1 - 10^(-dB / 10)
    np.testing.assert_allclose(msssim(table['msssim_db'].astype(float)),
                               msssim(df['msssim_db'].values), rtol=0, atol=1e-5)


def msssim(db):
    return 1.0 - 10.0 ** (-db / 10.0)


def test_jpeg_leg_matches_reference(sweeps):
    table, df = sweeps['jpeg']
    assert len(table) == 2 * len(QUALITIES)
    assert list(table['quality']) == list(df['quality'])
    assert_rows_match(table, df, 1e-9)


def test_dcn_leg_matches_reference(sweeps):
    table, df = sweeps['dcn']
    assert len(table) == 2 and set(table['codec']) == {'TwitterDCN-8C/soft-codebook_Q-5bpf_'
                                                       'S+_H+250.00'}
    assert_rows_match(table, df, 1e-6)


@pytest.mark.parametrize('leg', ['jpeg', 'dcn'])
def test_each_package_reads_the_others_cache(sweeps, leg):
    port_dir, ref_dir = sweeps['dirs']
    table, df = sweeps[leg]
    name = f'{leg}.csv'
    # the port reads the reference's CSV as a cache hit, value for value
    crossed = str(os.path.join(port_dir, 'crossed_' + leg))
    os.makedirs(crossed)
    for f in os.listdir(port_dir):
        if f.endswith('.png'):
            shutil.copy(os.path.join(port_dir, f), crossed)
    shutil.copy(os.path.join(ref_dir, name), os.path.join(crossed, name))
    if leg == 'jpeg':
        read = rd.get_jpeg_df(crossed, qualities=QUALITIES, device='cpu')
    else:
        read = rd.get_dcn_df(crossed, '/nonexistent', device='cpu')   # a hit builds nothing
    for column in rd.RD_COLUMNS:
        np.testing.assert_array_equal(read[column], df[column].values)
    # and the port's CSV is the one pandas writes for its rows, which pandas
    # reads with the dtypes of the reference's own
    with open(os.path.join(port_dir, name)) as f:
        assert f.read() == pd.DataFrame(table.rows, columns=rd.RD_COLUMNS).to_csv(index=False)
    ours = pd.read_csv(os.path.join(port_dir, name))
    assert list(ours.dtypes) == list(pd.read_csv(os.path.join(ref_dir, name)).dtypes)


def test_stale_cache_is_rebuilt(tmp_path):
    directory = write_images(str(tmp_path / 'imgs'), n=1, height=32, width=48)
    first = rd.get_jpeg_df(directory, qualities=[30, 60], device='cpu')
    assert sorted(set(first['quality'])) == [30, 60]
    again = rd.get_jpeg_df(directory, qualities=[30, 60, 90], device='cpu')
    assert sorted(set(again['quality'])) == [30, 60, 90]
    write_images(str(tmp_path / 'imgs'), n=2, height=32, width=48)
    grown = rd.get_jpeg_df(directory, qualities=[30, 60, 90], device='cpu')
    assert set(grown['filename']) == {'img_0.png', 'img_1.png'}


@pytest.mark.parametrize('metric', ['ssim', 'psnr', 'msssim_db'])
def test_fits_match_reference(sweeps, metric):
    """Both packages' fits of the same samples: the reference's sweep as
    pandas read it back, its rows given to the port's table."""
    port_dir, ref_dir = sweeps['dirs']
    df = pd.read_csv(os.path.join(ref_dir, 'jpeg.csv'))
    table = rd.Table(df.to_dict('records'), list(df.columns))
    for port_fit, ref_fit in ((rd.fit_rd_curve, jrd.fit_rd_curve),
                              (rd.fit_rd_curve_per_image, jrd.fit_rd_curve_per_image)):
        grid, fitted = port_fit(table, metric)
        grid_ref, fitted_ref = ref_fit(df, metric)
        np.testing.assert_allclose(grid, grid_ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(fitted, fitted_ref, rtol=0, atol=1e-9)
    bpp, quality = rd.aggregate_rd(table, metric)
    bpp_ref, quality_ref = jrd.aggregate_rd(df, metric)
    np.testing.assert_allclose(bpp, bpp_ref, rtol=1e-12)
    np.testing.assert_allclose(quality, quality_ref, rtol=1e-12)


def test_table_csv_round_trip_and_grouping(tmp_path):
    rows = [{'image_id': 1, 'filename': 'b,c.png', 'codec': 'x', 'quality': np.nan,
             'ssim': 0.1, 'psnr': 1e-7, 'msssim_db': 12.5, 'bytes': 7, 'bpp': 0.5},
            {'image_id': 0, 'filename': 'a.png', 'codec': 'x', 'quality': np.nan,
             'ssim': 0.2, 'psnr': np.nan, 'msssim_db': 3.0, 'bytes': 9, 'bpp': 0.25}]
    table = rd.Table(rows)
    path = str(tmp_path / 't.csv')
    table.to_csv(path)
    pd.DataFrame(rows, columns=rd.RD_COLUMNS).to_csv(str(tmp_path / 'p.csv'), index=False)
    assert open(path).read() == open(str(tmp_path / 'p.csv')).read()
    back = rd.Table.read_csv(path)
    assert back['filename'].tolist() == ['b,c.png', 'a.png']
    assert back['bytes'].dtype.kind == 'i' and np.isnan(back['quality']).all()
    assert [key for key, _ in back.groupby('image_id')] == [0, 1]
    assert len(back.dropna(['psnr'])) == 1 and rd.Table(columns=rd.RD_COLUMNS).empty


@pytest.mark.parametrize('leg, codec, n_qualities', [
    ('jpeg2k', 'jpeg2000', 21), ('bpg', 'bpg', 11), ('webp', 'webp', 18), ('avif', 'avif', 18)])
def test_legs_the_port_lacks_raise(tmp_path, leg, codec, n_qualities):
    """The legs the port once refused (they raised, naming the item that
    ported them) each give their table of R/D rows at the reference's default
    qualities, or, for BPG without bpgenc/bpgdec, the reference's empty table."""
    directory = write_images(str(tmp_path / 'imgs'), n=1, height=32, width=48)
    table = getattr(rd, f'get_{leg}_df')(directory, device='cpu')
    assert table.columns == rd.RD_COLUMNS
    if leg == 'bpg' and not rd.bpg_helpers.bpg_available():
        assert table.empty and not os.path.exists(os.path.join(directory, 'bpg.csv'))
        return
    assert len(table) == n_qualities and set(table['codec']) == {codec}
    assert set(table['filename']) == {'img_0.png'}
    for column in ('ssim', 'psnr', 'msssim_db', 'bpp'):
        assert np.isfinite(table[column].astype(float)).all()
    assert (table['bytes'].astype(int) > 0).all()


def test_ppm_and_bmp_images(tmp_path):
    image = (fixtures.procedural_image(16, 24, 1) * 255).astype(np.uint8)
    with open(tmp_path / 'a.ppm', 'wb') as f:
        f.write(b'P6\n# a comment\n24 16\n255\n' + image.tobytes())
    names, images = rd._load_images(str(tmp_path))
    assert names == ['a.ppm']
    np.testing.assert_array_equal(images[0], image.astype(np.float32) / 255)
    # a BMP beside it is read too, as imageio reads it
    imageio.imwrite(str(tmp_path / 'b.bmp'), image[::-1])
    names, images = rd._load_images(str(tmp_path))
    assert names == ['a.ppm', 'b.bmp']
    np.testing.assert_array_equal(images[1], image[::-1].astype(np.float32) / 255)
