"""The port's development (PyTorch float64 on the CPU) against the JAX
package's numpy pipeline: the three demosaicers in all four CFA patterns
within 1e-12 (they sum in scipy.ndimage's order, so in fact bit for bit),
with Menon's direction decisions compared pixel by pixel (no flip expected
at these sizes); ``develop`` for each brightness mode; ``process`` and
``process_auto`` of DNG and vendor captures, whose uint8 values may differ
by ±1 on at most 1e-5 of them (the last bit of pow); the percentile helper
beyond ``torch.quantile``'s 2^24 elements."""
import numpy as np
import pytest
import torch
from scipy.ndimage import convolve, convolve1d

from neural_imaging_tpu.data import fixtures as jfixtures
from neural_imaging_tpu.data import menon as jmenon
from neural_imaging_tpu.data import raw as jraw
from neural_imaging_tpu_torch.data import fixtures, menon, raw

CFAS = ['RGGB', 'GBRG', 'BGGR', 'GRBG']
SHAPES = [(128, 192), (34, 46)]
TOL = 1e-12
MAX_U8_SHARE = 1e-5
SRGB = np.array([[1.82691061, -0.65497452, -0.17193617],
                 [-0.00683982, 1.33216381, -0.32532394],
                 [0.06269717, -0.40055895, 1.33786178]])
REFERENCE = {'bilinear': jraw.demosaic_bilinear, 'malvar': jraw.demosaic_malvar,
             'menon': jmenon.demosaic_menon}


def mosaic(shape, seed):
    """Scene-like content: a smooth field, edges, noise, a flat patch (where
    Menon's two directional gradients tie at exactly 0) and clipped values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    m = 0.4 + 0.3 * np.sin(yy / 5.0) * np.cos(xx / 9.0) + 0.02 * rng.standard_normal(shape)
    m[:, shape[1] // 2:] += 0.3
    m[:8, :8] = 0.25
    return np.clip(m, 0, 1)


def reference_directions(m, cfa):
    """The reference's decision del_V >= del_H (jmenon.demosaic_menon's steps 1-2)."""
    R_m, _, B_m = (mk.astype(bool) for mk in jraw._cfa_masks(m.shape, cfa))
    X_m = R_m | B_m
    fir = jmenon._H0 + jmenon._H1
    C_H = np.where(X_m, m - np.where(X_m, convolve1d(m, fir, axis=1, mode='mirror'), m), 0.0)
    C_V = np.where(X_m, m - np.where(X_m, convolve1d(m, fir, axis=0, mode='mirror'), m), 0.0)
    del_H = convolve(np.abs(C_H - jmenon._shift(C_H, 0, 2)), jmenon._K, mode='mirror')
    del_V = convolve(np.abs(C_V - jmenon._shift(C_V, 2, 0)), jmenon._K.T, mode='mirror')
    return del_V >= del_H


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('demosaicing', sorted(REFERENCE))
def test_demosaicing_matches_the_reference(demosaicing, cfa, shape):
    m = mosaic(shape, sum(shape))
    port = raw.DEMOSAICERS[demosaicing](torch.from_numpy(m), cfa)
    assert port.dtype == torch.float64 and tuple(port.shape) == (*shape, 3)
    ref = REFERENCE[demosaicing](m, cfa)
    if demosaicing == 'menon':
        flips = int((menon.directions(torch.from_numpy(m), cfa)[0].numpy()
                     != reference_directions(m, cfa)).sum())
        assert flips == 0
    assert float(np.abs(port.numpy() - ref).max()) <= TOL


@pytest.mark.parametrize('kernel', [jmenon._K, jmenon._K.T, raw._GR_GB, raw._RG_BR_BG_RB,
                                    np.ones((3, 3)) / 9, np.zeros((3, 3))])
def test_convolve_is_scipys_mirror_convolution(kernel):
    x = np.random.default_rng(1).random((11, 17))
    np.testing.assert_array_equal(raw.convolve(torch.from_numpy(x), kernel).numpy(),
                                  convolve(x, kernel, mode='mirror'))


@pytest.mark.parametrize('axis', [0, 1])
def test_convolve1d_is_scipys_mirror_convolution(axis):
    x = np.random.default_rng(2).random((9, 13))
    w = jmenon._H0 + jmenon._H1
    np.testing.assert_array_equal(raw.convolve1d(torch.from_numpy(x), w, axis).numpy(),
                                  convolve1d(x, w, axis=axis, mode='mirror'))
    with pytest.raises(ValueError, match='symmetric'):
        raw.convolve1d(torch.from_numpy(x), [1.0, 2.0, 3.0], axis)


@pytest.mark.parametrize('brightness', ['percentile', 'shift', None])
@pytest.mark.parametrize('demosaicing', sorted(REFERENCE))
def test_develop_matches_the_reference(demosaicing, brightness):
    m = mosaic((64, 96), 5)
    for cam2srgb in (SRGB, None):
        port = raw.develop(m, 'GBRG', cam2srgb, brightness=brightness, demosaicing=demosaicing,
                           device='cpu')
        ref = jraw.develop_mosaic(m, 'GBRG', cam2srgb, brightness=brightness,
                                  demosaicing=demosaicing)
        assert float(np.abs(port.numpy() - ref).max()) <= TOL
        # numpy's einsum order: the camera → sRGB products are bit-equal
        np.testing.assert_array_equal(
            raw.develop(m, 'GBRG', cam2srgb, use_gamma=False, demosaicing=demosaicing,
                        brightness=None, device='cpu').numpy(),
            jraw.develop_mosaic(m, 'GBRG', cam2srgb, use_gamma=False, brightness=None,
                                demosaicing=demosaicing))


def _u8_report(port, ref):
    diff = np.abs(port.astype(int) - ref.astype(int))
    return int(diff.max()), float((diff > 0).mean())


@pytest.fixture(scope='module')
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp('captures')
    image = fixtures.procedural_image(96, 128, 21)
    paths = [fixtures.make_dng_capture(str(d / 'a.dng'), image_rgb=image, cfa_pattern='GBRG'),
             fixtures.make_dng_capture(str(d / 'b.dng'), image_rgb=image, cfa_pattern='RGGB',
                                       compression='ljpeg'),
             fixtures.make_camera_capture(str(d / 'c.cr2'), image_rgb=image, cfa_pattern='BGGR'),
             fixtures.make_camera_capture(str(d / 'd.nef'), image_rgb=image, cfa_pattern='GRBG'),
             fixtures.make_camera_capture(str(d / 'e.arw'), image_rgb=image, cfa_pattern='GBRG')]
    npz = str(d / 'f.nraw.npz')
    raw.save_nraw(npz, (np.random.default_rng(3).random((48, 64)) * 4000 + 100).astype(np.uint16),
                  cfa_pattern='RGGB', black=100, saturation=4200, cam_mul=(1.8, 1, 1.4, 1),
                  cam2srgb=SRGB)
    return paths + [npz]


@pytest.mark.parametrize('brightness', ['percentile', 'shift', None])
@pytest.mark.parametrize('demosaicing', sorted(REFERENCE))
def test_process_matches_the_reference(captures, demosaicing, brightness):
    for path in captures:
        port = raw.process(path, demosaicing=demosaicing, brightness=brightness, device='cpu')
        ref = jraw.process(path, demosaicing=demosaicing, brightness=brightness)
        assert port.dtype == torch.float64 and port.shape == ref.shape
        assert float(np.abs(port.numpy() - ref).max()) <= TOL
        worst, share = _u8_report(raw.to_uint8(port), (255 * ref).round().astype(np.uint8))
        assert worst <= 1 and share <= MAX_U8_SHARE, (path, worst, share)
    assert tuple(raw.process(captures[0], expand=True, device='cpu').shape) == (1, 96, 128, 3)


@pytest.mark.parametrize('use_srgb,use_gamma', [(False, True), (True, False)])
def test_process_options_match_the_reference(captures, use_srgb, use_gamma):
    port = raw.process(captures[2], use_srgb=use_srgb, use_gamma=use_gamma, device='cpu')
    ref = jraw.process(captures[2], use_srgb=use_srgb, use_gamma=use_gamma)
    assert float(np.abs(port.numpy() - ref).max()) <= TOL


def test_process_auto_matches_the_reference(captures):
    for path in captures:
        port, ref = raw.process_auto(path, device='cpu'), jraw.process_auto(path)
        assert port.dtype == np.uint8 and port.shape == ref.shape
        worst, share = _u8_report(port, ref)
        assert worst <= 1 and share <= MAX_U8_SHARE


def test_unsupported_options_raise_as_the_reference(captures):
    for bad in (dict(brightness='gamma'), dict(demosaicing='ahd')):
        with pytest.raises(ValueError, match='Unsupported'):
            jraw.process(captures[0], **bad)
        with pytest.raises(ValueError, match='Unsupported'):
            raw.process(captures[0], device='cpu', **bad)
    with pytest.raises(ValueError, match='port reads'):
        raw.process(captures[0].replace('.dng', '.raf'), device='cpu')


def test_percentile_beyond_the_quantile_limit():
    """np.percentile's linear interpolation, bit for bit, on more elements
    than torch.quantile takes (2^24), and at the ends of the range."""
    rng = np.random.default_rng(9)
    x = rng.random(2 ** 24 + 3001)
    t = torch.from_numpy(x)
    with pytest.raises(RuntimeError):
        torch.quantile(t, 0.005)
    s = torch.sort(t).values
    qs = (0.5, 99.5, 50.0, 0.0, 100.0, 33.3)
    for q, want in zip(qs, np.percentile(x, qs)):
        assert float(raw.percentile(t, q, sorted_values=s)) == want
    small = rng.random((7, 5, 3))
    for q in (0.5, 99.5, 75.0):
        assert float(raw.percentile(torch.from_numpy(small), q)) == np.percentile(small, q)


def test_develop_mosaic_keeps_the_host_bilinear_path_and_reaches_the_others():
    m = mosaic((32, 48), 7)
    np.testing.assert_array_equal(raw.develop_mosaic(m, 'GBRG', SRGB, brightness='shift'),
                                  jraw.develop_mosaic(m, 'GBRG', SRGB, brightness='shift'))
    for demosaicing in ('malvar', 'menon'):
        port = raw.develop_mosaic(m, 'RGGB', SRGB, demosaicing=demosaicing)
        assert isinstance(port, np.ndarray)
        assert np.abs(port - jraw.develop_mosaic(m, 'RGGB', SRGB,
                                                 demosaicing=demosaicing)).max() <= TOL


def test_save_nraw_writes_the_reference_container(tmp_path):
    m = (np.random.default_rng(4).random((8, 12)) * 60000).astype(np.uint16)
    raw.save_nraw(str(tmp_path / 'p.nraw.npz'), m, black=12, cam_mul=(2, 1, 1.5, 1))
    jraw.save_nraw(str(tmp_path / 'r.nraw.npz'), m, black=12, cam_mul=(2, 1, 1.5, 1))
    port, ref = np.load(str(tmp_path / 'p.nraw.npz')), np.load(str(tmp_path / 'r.nraw.npz'))
    assert sorted(port.files) == sorted(ref.files)
    for key in port.files:
        np.testing.assert_array_equal(port[key], ref[key])
        assert port[key].dtype == ref[key].dtype


@pytest.mark.parametrize('entry', ['develop', 'process', 'process_auto', 'quality'])
def test_development_defaults_to_cuda_and_refuses_without_it(entry, captures, tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        if entry == 'develop':
            raw.develop(np.zeros((8, 8)), 'GBRG')
        elif entry == 'process':
            raw.process(captures[0])
        elif entry == 'process_auto':
            raw.process_auto(captures[0])
        else:
            fixtures.make_quality_dataset(str(tmp_path / 'q'), n_images=1, height=16, width=16)


def test_reference_fixture_still_develops_with_menon(tmp_path, monkeypatch):
    """The procedural half of make_quality_dataset develops its targets with
    Menon in both packages: the arrays equal, the PNGs within ±1."""
    monkeypatch.setattr(jfixtures, 'real_photo', lambda: None)
    fixtures.make_quality_dataset(str(tmp_path / 'p'), n_images=2, height=32, width=48,
                                  device='cpu')
    jfixtures.make_quality_dataset(str(tmp_path / 'r'), n_images=2, height=32, width=48)
    from neural_imaging_tpu_torch.data.png import read_png
    for i in range(2):
        name = f'quality_{i:04d}'
        np.testing.assert_array_equal(np.load(tmp_path / 'p' / f'{name}.npy'),
                                      np.load(tmp_path / 'r' / f'{name}.npy'))
        worst, _ = _u8_report(read_png(str(tmp_path / 'p' / f'{name}.png')),
                              read_png(str(tmp_path / 'r' / f'{name}.png')))
        assert worst <= 1
