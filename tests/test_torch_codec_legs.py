"""The port's host image codecs and the rate-distortion legs they serve
(``compression/jp2_helpers.py``, ``webp.py``, ``avif.py``, ``hevc.py``,
``bpg_helpers.py``) against the JAX package's, which run them through
OpenCV, Pillow and the same ctypes bindings, on two procedural 64x96 images
written with the port's ``write_png``.

Tolerances:
- WebP and JPEG 2000 rows: bytes equal, SSIM and PSNR within 1e-9 (the same
  decoded pixels through the same float64 metrics), MS-SSIM within 1e-5
  (``assert_rows_match``);
- JPEG 2000 files: the tile-parts byte for byte and the decoded pixels equal
  to OpenCV's at knobs 20, 100 and 500 (libopenjp2 2.5.0 here against
  OpenCV's 2.5.3: only the COM segment's version string differs);
- AVIF: the port decodes Pillow's files within 1 of Pillow's pixels (0 here);
  its own rows within 10% in bytes and 0.5 dB in PSNR of Pillow's at
  qualities 30 and 70 (libavif 0.11.1 and libaom 3.6 against Pillow's 1.3);
- HEVC: the bytes and pixels of the JAX module, whose settings include a
  'frames' parameter that x265 has no name for (x265_param_parse refuses it,
  so its encode_rgb always raises); the reference runs here with that one
  setting dropped, as the port drops it.
A test skips only where ctypes cannot load its library, and says so."""
import ctypes
import importlib.util
import io
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from neural_imaging_tpu.compression import bpg_helpers as jbpg
from neural_imaging_tpu.compression import hevc as jhevc
from neural_imaging_tpu.compression import jp2_helpers as jjp2
from neural_imaging_tpu.compression import ratedistortion as jrd
from neural_imaging_tpu_torch.compression import avif, bpg_helpers, hevc, jp2_helpers
from neural_imaging_tpu_torch.compression import ratedistortion as rd
from neural_imaging_tpu_torch.compression import webp
from neural_imaging_tpu_torch.data import fixtures
from neural_imaging_tpu_torch.data.png import write_png

from test_torch_ratedistortion import assert_rows_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVIF_BYTES_TOL, AVIF_PSNR_TOL = 0.10, 0.5


def _load_jax_rd_tests():
    """The JAX package's rate-distortion tests as a module (for their BPG
    header builder), under a name pytest does not collect."""
    spec = importlib.util.spec_from_file_location(
        '_jax_rd_tests', os.path.join(ROOT, 'tests', 'test_ratedistortion.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loadable(module):
    """pytest.skip naming the reason where ctypes cannot load the module's library."""
    try:
        module.library()
    except RuntimeError as e:
        pytest.skip(f'ctypes cannot load the library: {e}')


def images(n=2):
    return [(fixtures.procedural_image(64, 96, 40 + i) * 255).astype(np.uint8) for i in range(n)]


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    """Two copies of one directory of the two images, one for each package."""
    port_dir = str(tmp_path_factory.mktemp('port'))
    for i, image in enumerate(images()):
        write_png(os.path.join(port_dir, f'img_{i}.png'), image)
    ref_dir = str(tmp_path_factory.mktemp('ref'))
    shutil.rmtree(ref_dir)
    shutil.copytree(port_dir, ref_dir)
    return port_dir, ref_dir


def psnr_u8(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


# -- the legs in both packages --------------------------------------------------------------

@pytest.mark.parametrize('leg, module', [('webp', webp), ('jpeg2k', jp2_helpers)])
def test_leg_matches_reference(dirs, leg, module):
    loadable(module)
    port_dir, ref_dir = dirs
    table = getattr(rd, f'get_{leg}_df')(port_dir, device='cpu')
    df = getattr(jrd, f'get_{leg}_df')(ref_dir)
    assert list(table['quality']) == list(df['quality'])
    assert_rows_match(table, df, 1e-9)


def test_avif_leg_near_reference(dirs):
    loadable(avif)
    port_dir, ref_dir = dirs
    qualities = (30, 70)
    table = rd.get_avif_df(port_dir, qualities=qualities, device='cpu')
    df = jrd.get_avif_df(ref_dir, qualities=qualities)
    assert table.columns == list(df.columns) == rd.RD_COLUMNS
    for column in ('image_id', 'filename', 'codec', 'quality'):
        assert list(table[column]) == list(df[column])
    ratio = table['bytes'].astype(float) / df['bytes'].values - 1
    assert np.abs(ratio).max() <= AVIF_BYTES_TOL, ratio
    psnr_diff = table['psnr'].astype(float) - df['psnr'].values
    assert np.abs(psnr_diff).max() <= AVIF_PSNR_TOL, psnr_diff
    # bytes and PSNR rise with quality, image by image
    for image_id, sel in table.groupby('image_id'):
        assert list(sel['quality']) == list(qualities)
        assert np.all(np.diff(sel['bytes'].astype(float)) > 0)
        assert np.all(np.diff(sel['psnr'].astype(float)) > 0)


def test_bpg_leg_gated_as_reference(dirs):
    port_dir, ref_dir = dirs
    assert bpg_helpers.bpg_available() == jbpg.bpg_available()
    table, df = rd.get_bpg_df(port_dir, device='cpu'), jrd.get_bpg_df(ref_dir)
    assert table.columns == list(df.columns) == rd.RD_COLUMNS
    if not jbpg.bpg_available():
        assert table.empty and df.empty
        with pytest.raises(RuntimeError, match='bpgenc/bpgdec'):
            bpg_helpers.compress(np.zeros((16, 16, 3)))
    else:
        assert_rows_match(table, df, 1e-9)


def test_codec_libraries_names_each_library():
    found = rd.codec_libraries()
    assert list(found) == ['libopenjp2', 'libwebp', 'libavif', 'libx265', 'libde265',
                           'bpgenc/bpgdec']
    for name, module in (('libopenjp2', jp2_helpers), ('libwebp', webp), ('libavif', avif)):
        ok, text = found[name]
        assert ok == (rd._library_error(module) is None) and text
    assert found['bpgenc/bpgdec'][0] == bpg_helpers.bpg_available()


# -- WebP ----------------------------------------------------------------------------------

@pytest.mark.parametrize('quality', [10, 50, 90])
def test_webp_bytes_and_pixels_are_pillows(quality):
    loadable(webp)
    for image in images():
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, 'WEBP', quality=quality, method=4)
        data = webp.encode(image, quality)
        assert data == buf.getvalue()
        np.testing.assert_array_equal(
            webp.decode(data), np.asarray(Image.open(io.BytesIO(data)).convert('RGB')))


# -- JPEG 2000 -----------------------------------------------------------------------------

def cv2_jp2(image, q):
    ok, buf = cv2.imencode('.jp2', cv2.cvtColor(image, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, q])
    assert ok
    decoded = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    return bytes(buf), decoded


def tile_parts(data):
    """The codestream from its first SOT marker: the tile-parts and EOC."""
    start, end = jp2_helpers._find_codestream(data)
    codestream = data[start:end]
    return codestream[codestream.index(b'\xff\x90'):]


@pytest.mark.parametrize('q', [20, 100, 500])
def test_jp2_payload_and_pixels_are_opencvs(q):
    loadable(jp2_helpers)
    for image in images():
        theirs, decoded = cv2_jp2(image, q)
        ours = jp2_helpers._encode(jp2_helpers.library(), image, q)
        assert jp2_helpers.jp2_payload_bytes(ours) == jjp2.jp2_payload_bytes(theirs)
        assert tile_parts(ours) == tile_parts(theirs)
        np.testing.assert_array_equal(jp2_helpers.decode_jp2(ours), decoded)
        np.testing.assert_array_equal(jp2_helpers.decode_jp2(theirs), decoded)


@pytest.mark.parametrize('q', [1, 20, 100, 500, 1000])
def test_jp2_payload_count_is_references(q):
    """jp2_payload_bytes on files OpenCV writes, and on their raw codestreams."""
    for image in images():
        theirs, _ = cv2_jp2(image, q)
        assert jp2_helpers.jp2_payload_bytes(theirs) == jjp2.jp2_payload_bytes(theirs)
        start, end = jjp2._find_codestream(theirs)
        assert jp2_helpers._find_codestream(theirs) == (start, end)
        raw = theirs[start:end]
        assert jp2_helpers.jp2_payload_bytes(raw) == jjp2.jp2_payload_bytes(raw)
    with pytest.raises(ValueError):
        jp2_helpers.jp2_payload_bytes(b'not a jp2 file at all')


@pytest.mark.parametrize('target', [25.0, 33.0, 41.0])
def test_jp2_psnr_target_as_reference(target):
    """The bisection lands on the reference's file, within 1 dB of the target
    (the reference's own test's bound)."""
    loadable(jp2_helpers)
    image = images(1)[0]
    buf, decoded = jp2_helpers.encode_jp2(image, psnr_target=target)
    ref_buf, ref_decoded = jjp2.encode_jp2(image, psnr_target=target)
    assert jp2_helpers.jp2_payload_bytes(buf) == jjp2.jp2_payload_bytes(ref_buf)
    np.testing.assert_array_equal(decoded, ref_decoded)
    assert abs(psnr_u8(image, decoded * 255.0) - target) <= 1.0


def test_jp2_rate_target_and_argument_check():
    loadable(jp2_helpers)
    image = (fixtures.procedural_image(128, 128, seed=3) * 255).astype(np.uint8)
    buf, _ = jp2_helpers.encode_jp2(image, rate_bpp=1.0)
    ref_buf, _ = jjp2.encode_jp2(image, rate_bpp=1.0)
    assert jp2_helpers.jp2_payload_bytes(buf) == jjp2.jp2_payload_bytes(ref_buf)
    assert 0.7 < 8 * len(buf) / (128 * 128) < 1.3
    with pytest.raises(ValueError, match='exactly one'):
        jp2_helpers.encode_jp2(image)


def test_jp2_layout_check_refuses_a_wrong_struct(monkeypatch):
    """A declared structure that disagrees with the library is refused."""
    lib = jp2_helpers.library()

    class Shifted(ctypes.Structure):
        _fields_ = [('pad', ctypes.c_int)] + jp2_helpers.CParameters._fields_

    monkeypatch.setattr(jp2_helpers, 'CParameters', Shifted)
    with pytest.raises(jp2_helpers.OpenJPEGError, match='layout mismatch'):
        jp2_helpers._check_layout(lib)


# -- AVIF ----------------------------------------------------------------------------------

@pytest.mark.parametrize('quality', [10, 50, 90])
def test_avif_decodes_pillows_files(quality):
    loadable(avif)
    for image in images():
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, 'AVIF', quality=quality, speed=6)
        theirs = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert('RGB')).astype(int)
        diff = np.abs(avif.decode(buf.getvalue()).astype(int) - theirs).max()
        assert diff <= 1, diff


def test_avif_quantizer_is_libavif_1x():
    assert [avif.quantizer(q) for q in (0, 10, 50, 75, 90, 100)] == [63, 57, 32, 16, 6, 0]


def test_avif_layout_check_refuses_wrong_offsets():
    loadable(avif)
    lib = avif.library()
    layout = {part: dict(fields) for part, fields in lib.layout.items()}
    layout['encoder']['speed'] += 4
    with pytest.raises(avif.AVIFError, match='layout mismatch'):
        avif._check_layout(lib, layout)
    layout = {part: dict(fields) for part, fields in lib.layout.items()}
    layout['rgb']['size'] -= 8                       # the library writes past it
    with pytest.raises(avif.AVIFError, match='rgb.written'):
        avif._check_layout(lib, layout)


# -- HEVC ----------------------------------------------------------------------------------

class _WithoutFrames:
    """The reference's libx265 handle, with its one refused setting,
    'frames', dropped as the port drops it."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def x265_param_parse(self, param, key, value):
        return 0 if key == b'frames' else self._lib.x265_param_parse(param, key, value)


@pytest.fixture
def reference_hevc(monkeypatch):
    if not jhevc.available():
        pytest.skip('ctypes cannot load libx265 / libde265')
    x265 = jhevc._handles()[0]
    monkeypatch.setattr(x265, 'lib', _WithoutFrames(x265.lib))
    return jhevc


def test_reference_hevc_refuses_frames():
    if not jhevc.available():
        pytest.skip('ctypes cannot load libx265 / libde265')
    with pytest.raises(jhevc.HEVCError, match='frames'):
        jhevc.encode_rgb(images(1)[0], 28)


@pytest.mark.parametrize('qp', [22, 32])
def test_hevc_bytes_and_pixels_are_references(reference_hevc, qp):
    assert hevc.available()
    for image in images():
        data = hevc.encode_rgb(image, qp)
        assert data == reference_hevc.encode_rgb(image, qp)
        np.testing.assert_array_equal(hevc.decode_rgb(data), reference_hevc.decode_rgb(data))
    # odd sizes are padded to even and cropped back
    odd = images(1)[0][:63, :95]
    data = hevc.encode_rgb(odd, qp)
    assert data == reference_hevc.encode_rgb(odd, qp)
    np.testing.assert_array_equal(hevc.decode_rgb(data, 63, 95),
                                  reference_hevc.decode_rgb(data, 63, 95))


def test_hevc_versions():
    if not hevc.available():
        pytest.skip('ctypes cannot load libx265 / libde265')
    versions = hevc.versions()
    assert set(versions) == {'x265', 'de265'} and all(versions.values())


# -- BPG -----------------------------------------------------------------------------------

_JAX_RD_TESTS = _load_jax_rd_tests()


@pytest.mark.parametrize('width, height, pdl, ext, payload, want', [
    (768, 512, 1000, None, b'\0' * 1000, 1000),     # multi-byte ue7 sizes
    (16, 16, 0, None, b'x' * 77, 77),                # zero length: the rest of the file
    (16, 16, 0, b'E' * 21, b'x' * 50, 50),           # the extension block is skipped
])
def test_bpg_header_as_reference(tmp_path, width, height, pdl, ext, payload, want):
    path = str(tmp_path / 'a.bpg')
    with open(path, 'wb') as f:
        f.write(_JAX_RD_TESTS.TestBPGHeaderParser._header(width, height, pdl, ext=ext,
                                                          payload=payload))
    info = bpg_helpers.bpg_header_info(path)
    assert info == jbpg.bpg_header_info(path)
    assert (info['width'], info['height'], info['payload_bytes']) == (width, height, want)


def test_bpg_ue7_and_non_bpg(tmp_path):
    for blob in (bytes([0x05]), bytes([0x81, 0x05]), bytes([0xFF, 0xFF, 0x7F])):
        assert bpg_helpers._read_ue7(blob, 0) == jbpg._read_ue7(blob, 0)
    path = str(tmp_path / 'd.bpg')
    with open(path, 'wb') as f:
        f.write(b'JUNKJUNK')
    with pytest.raises(ValueError, match='Not a BPG file'):
        bpg_helpers.bpg_header_info(path)


# -- a host without the libraries (the GPU machine has none of them) -----------------------

def test_legs_without_their_libraries(dirs, tmp_path, monkeypatch, caplog):
    """Each library refused as a host without it refuses it: codec_libraries
    names each reason; WebP and AVIF give the reference's empty table with a
    warning, JPEG 2000 raises naming libopenjp2 (where the reference fails to
    import OpenCV), and a cache that covers the sweep is still read."""
    port_dir = str(tmp_path / 'imgs')
    shutil.copytree(dirs[0], port_dir, ignore=shutil.ignore_patterns('*.csv'))
    cached = rd.get_jpeg2k_df(port_dir, qualities=(31,), device='cpu')

    def absent(error, name):
        def load():
            raise error(f'{name} not loadable: no such file')
        return load

    monkeypatch.setattr(jp2_helpers, 'library', absent(jp2_helpers.OpenJPEGError, 'libopenjp2'))
    monkeypatch.setattr(webp, 'library', absent(webp.WebPError, 'libwebp'))
    monkeypatch.setattr(avif, 'library', absent(avif.AVIFError, 'libavif'))
    monkeypatch.setattr(hevc, 'versions', absent(hevc.HEVCError, 'libx265'))
    monkeypatch.setattr(hevc, '_X265', absent(hevc.HEVCError, 'libx265'))
    found = rd.codec_libraries()
    for name in ('libopenjp2', 'libwebp', 'libavif', 'libx265'):
        assert found[name] == (False, f'{name} not loadable: no such file')
    assert found['libde265'][0] and 'the codec does not' in found['libde265'][1]
    with caplog.at_level('WARNING'):
        for leg in (rd.get_webp_df, rd.get_avif_df):
            table = leg(port_dir, qualities=(40,), device='cpu')
            assert table.empty and table.columns == rd.RD_COLUMNS
    assert 'libwebp not loadable' in caplog.text and 'libavif not loadable' in caplog.text
    assert rd.get_jpeg2k_df(port_dir, qualities=(31,), device='cpu').rows == cached.rows
    with pytest.raises(jp2_helpers.OpenJPEGError, match='libopenjp2'):
        rd.get_jpeg2k_df(port_dir, qualities=(32,), device='cpu')
