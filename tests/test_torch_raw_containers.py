"""The port's RAW containers against the JAX package's: every container and
coding (DNG uncompressed at 16/14/12 bits and lossless JPEG, CR2, NEF
uncompressed, lossless and the three lossy layouts, ARW uncompressed,
lossless-JPEG tiled and cRAW with and without its encrypted SR2 chain) in
all four CFA patterns, written by one package and read by the other.
The files must be byte-identical, and the parsed mosaic, levels,
multipliers, colour matrix and CFA equal; ``raw.unpack`` must give the
reference's stack. Foreign bytes (``tests/support/foreign_raw.py``, built
from the specifications without either package's writers) are read by the
port's readers."""
import numpy as np
import pytest

from neural_imaging_tpu.data import camera_raw as jcamera_raw
from neural_imaging_tpu.data import dng as jdng
from neural_imaging_tpu.data import nikon as jnikon
from neural_imaging_tpu.data import raw as jraw
from neural_imaging_tpu.data import sony as jsony
from neural_imaging_tpu_torch.data import camera_raw, dng, ljpeg, nikon, raw, sony
from neural_imaging_tpu_torch.ops.kernels import EXAMPLE_SRGB
from support import foreign_raw

CFAS = ['RGGB', 'GBRG', 'BGGR', 'GRBG']
H, W = 32, 64                     # cRAW codes 32-column groups
BLACK, WHITE = 512, 16383
CAM_MUL = (2.0, 1.0, 1.5, 1.0)
POSTS = [1000 << 2, 2500 << 2, 3200 << 2, 3900 << 2]


def capture(bits=14, seed=0, h=H, w=W):
    """A smooth mosaic with noise and a few saturated and black samples."""
    rng = np.random.default_rng(seed)
    hi = (1 << bits) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    m = hi * (0.2 + 0.5 * np.sin(yy / 7.0) ** 2 * np.cos(xx / 11.0) ** 2)
    m = m + rng.normal(0, hi / 200, (h, w))
    m[0, :3] = hi
    m[-1, -3:] = 0
    return np.clip(m, 0, hi).round().astype(np.uint16)


def smooth_codes(seed=0):
    """11-bit codes whose 16-pixel blocks spread below 128: cRAW codes them exactly."""
    rng = np.random.default_rng(seed)
    base = np.linspace(200, 1500, H).astype(np.int32)[:, None]
    return np.clip(base + rng.integers(0, 60, (H, W)), 0, 2047).astype(np.uint16)


def _writers(mod, dng_mod):
    """name → (extension, writer(path, cfa)) of one package's modules."""
    m14, m12, m16 = capture(14), capture(12, 1), capture(16, 2)
    codes = smooth_codes()
    curve = jsony.build_curve(POSTS)
    linear = (curve[codes.astype(np.int32) << 1] >> 2).astype(np.uint16)
    levels = dict(black=BLACK, white=WHITE)
    full_curve = np.round(WHITE * (np.arange(4097) / 4096) ** 1.5).astype(np.uint16)
    return {
        'dng16': ('dng', lambda p, c: dng_mod.write_dng(
            p, m16, c, black=0, cam_mul=CAM_MUL, cam2srgb=EXAMPLE_SRGB)),
        'dng14': ('dng', lambda p, c: dng_mod.write_dng(
            p, m14, c, cam_mul=CAM_MUL, cam2srgb=EXAMPLE_SRGB, bits=14, **levels)),
        'dng12': ('dng', lambda p, c: dng_mod.write_dng(p, m12[:, :W - 2], c, bits=12)),
        'dng_ljpeg': ('dng', lambda p, c: dng_mod.write_dng(
            p, m14, c, cam_mul=CAM_MUL, cam2srgb=EXAMPLE_SRGB, bits=14, compression='ljpeg',
            **levels)),
        'cr2': ('cr2', lambda p, c: mod.write_cr2(p, m14, c, precision=14, cam_mul=CAM_MUL,
                                                  **levels)),
        'cr2_12': ('cr2', lambda p, c: mod.write_cr2(p, m12, c, precision=12, n_slices=2)),
        'nef14': ('nef', lambda p, c: mod.write_nef(p, m14, c, bits=14, **levels)),
        'nef12_no_black': ('nef', lambda p, c: mod.write_nef(p, m12, c, bits=12,
                                                             black_style='none')),
        'nef_lossless': ('nef', lambda p, c: mod.write_nef(
            p, m14, c, bits=14, compression='nikon-lossless', **levels)),
        'nef_lossless12': ('nef', lambda p, c: mod.write_nef(
            p, m12, c, bits=12, compression='nikon-lossless')),
        'nef_lossy': ('nef', lambda p, c: mod.write_nef(
            p, m14, c, bits=14, compression='nikon-lossy', **levels)),
        'nef_lossy_split': ('nef', lambda p, c: mod.write_nef(
            p, m14, c, bits=14, compression='nikon-lossy', nikon_split=H // 2, **levels)),
        'nef_lossy_curve': ('nef', lambda p, c: mod.write_nef(
            p, m12, c, bits=12, compression='nikon-lossy', nikon_curve=full_curve)),
        'arw16': ('arw', lambda p, c: mod.write_arw(p, m16, c, bits=16, black_style='sony',
                                                    **levels)),
        'arw_ljpeg_tiled': ('arw', lambda p, c: mod.write_arw(
            p, m14[:, :W - 6], c, bits=14, compression='ljpeg', tile_width=16, **levels)),
        'arw_craw': ('arw', lambda p, c: mod.write_arw(p, codes, c, compression='sony-craw')),
        'arw_craw_sr2': ('arw', lambda p, c: mod.write_arw_craw(
            p, linear, c, sr2_meta={'curve_posts': POSTS, 'black': (512, 510, 514, 512),
                                    'wb': (2200, 1024, 1024, 1900), 'key': 0xCAFEBABE})),
    }


PORT = _writers(camera_raw, dng)
REFERENCE = _writers(jcamera_raw, jdng)


def _read(mod, dng_mod, path):
    return dng_mod.read_dng(path) if path.endswith('.dng') else mod.read_camera_raw(path)


def _assert_same_parse(a, b):
    assert set(a) == set(b)
    np.testing.assert_array_equal(a['mosaic'], b['mosaic'])
    assert a['mosaic'].dtype == b['mosaic'].dtype
    for key in ('cfa_pattern', 'black', 'white', 'camera'):
        assert a[key] == b[key], key
    for key in ('cam_mul', 'cam2srgb'):
        np.testing.assert_array_equal(a[key], b[key])
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('name', sorted(PORT))
def test_written_files_are_the_reference_bytes(name, cfa, tmp_path):
    ext, write = PORT[name]
    ext_ref, write_ref = REFERENCE[name]
    port, ref = str(tmp_path / f'port.{ext}'), str(tmp_path / f'ref.{ext_ref}')
    write(port, cfa)
    write_ref(ref, cfa)
    assert open(port, 'rb').read() == open(ref, 'rb').read()


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('name', sorted(PORT))
def test_port_reads_what_the_reference_writes(name, cfa, tmp_path):
    ext, write_ref = REFERENCE[name]
    path = str(tmp_path / f'ref.{ext}')
    write_ref(path, cfa)
    _assert_same_parse(_read(camera_raw, dng, path), _read(jcamera_raw, jdng, path))
    for port, ref in zip(raw.unpack(path), jraw.unpack(path)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize('cfa', CFAS)
@pytest.mark.parametrize('name', sorted(PORT))
def test_reference_reads_what_the_port_writes(name, cfa, tmp_path):
    ext, write = PORT[name]
    path = str(tmp_path / f'port.{ext}')
    write(path, cfa)
    _assert_same_parse(_read(camera_raw, dng, path), _read(jcamera_raw, jdng, path))
    for stack, use_wb in ((False, True), (True, False)):
        for port, ref in zip(raw.unpack(path, stack=stack, use_wb=use_wb),
                             jraw.unpack(path, stack=stack, use_wb=use_wb)):
            np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize('name', ['dng14', 'cr2', 'nef_lossless', 'nef_lossy_split',
                                  'arw_craw_sr2'])
def test_round_trip_gives_the_mosaic_back(name, tmp_path):
    """Each coding's mosaic comes back: exactly for the lossless ones; for the
    lossy NEF, exactly on the rows before its tree split; for cRAW, exactly
    for content whose blocks code without loss."""
    ext, write = PORT[name]
    path = str(tmp_path / f'port.{ext}')
    write(path, 'GBRG')
    got = _read(camera_raw, dng, path)['mosaic']
    if name == 'arw_craw_sr2':
        codes = smooth_codes()
        want = (sony.build_curve(POSTS)[codes.astype(np.int32) << 1] >> 2).astype(np.uint16)
        np.testing.assert_array_equal(got, want)
    elif name == 'nef_lossy_split':
        np.testing.assert_array_equal(got[:H // 2], capture(14)[:H // 2])
        assert np.abs(got.astype(int) - capture(14)).max() < 64
    else:
        np.testing.assert_array_equal(got, capture(14))


def test_nef_lossy_reconstruction_matches_the_reference():
    m = capture(14, 5)
    for split in (0, 2, 5, H - 1):
        port = nikon.encode_lossy(m, 14, split=split)
        ref = jnikon.encode_lossy(m, 14, split=split)
        assert port[0] == ref[0] and port[2] == ref[2]
        np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize('blob', [
    lambda: nikon.build_meta(capture(14)),
    lambda: nikon.build_meta_lossy((1, 2, 3, 4)),
    lambda: nikon.build_meta_lossy((1, 2, 3, 4), curve_samples=np.arange(17) * 1024, split=9),
    lambda: nikon.build_meta_lossy((1, 2, 3, 4), full_curve=np.arange(4096) * 2),
])
def test_nikon_metadata_parses_as_the_reference(blob):
    b = blob()
    port, ref = nikon.parse_meta(b, bits=14), jnikon.parse_meta(b, bits=14)
    assert set(port) == set(ref)
    for key in port:
        np.testing.assert_array_equal(port[key], ref[key])


def test_sony_curve_cipher_and_codec_match_the_reference():
    curve = sony.build_curve(POSTS)
    np.testing.assert_array_equal(curve, jsony.build_curve(POSTS))
    assert sony.curve_white(curve) == jsony.curve_white(curve)
    blob = np.random.default_rng(11).integers(0, 256, 257, dtype=np.uint8).tobytes()
    assert sony.decrypt(blob, 0xDEADBEEF) == jsony.decrypt(blob, 0xDEADBEEF)
    codes = np.random.default_rng(3).integers(0, 2048, (16, 96)).astype(np.uint16)
    assert sony.encode(codes) == jsony.encode(codes)
    np.testing.assert_array_equal(sony.decode(sony.encode(codes), 16, 96, curve),
                                  jsony.decode(jsony.encode(codes), 16, 96, curve))


# -- foreign bytes ----------------------------------------------------------------------

@pytest.mark.parametrize('bits,endian,shape', [(16, '<', (6, 10)), (16, '>', (6, 10)),
                                               (12, '<', (5, 7)), (14, '>', (4, 9)),
                                               (12, '<', (8, 16))])
def test_port_reads_foreign_uncompressed_dngs(bits, endian, shape, tmp_path):
    m = np.random.default_rng(bits + shape[1]).integers(0, 1 << bits, shape).astype(np.uint16)
    path = tmp_path / 'f.dng'
    path.write_bytes(foreign_raw.foreign_dng(m, bits=bits, endian=endian, black=7))
    d = dng.read_dng(str(path))
    np.testing.assert_array_equal(d['mosaic'], m)
    assert d['cfa_pattern'] == 'GRBG' and d['black'] == 7.0     # codes (1, 0, 2, 1)
    _assert_same_parse(d, jdng.read_dng(str(path)))


def test_port_rejects_lsb_first_bit_packing(tmp_path):
    path = tmp_path / 'f2.dng'
    path.write_bytes(foreign_raw.foreign_dng(capture(12, h=4, w=6), bits=12, fill_order=2))
    with pytest.raises(dng.DNGError, match='FillOrder'):
        dng.read_dng(str(path))


@pytest.mark.parametrize('precision,ncomp,predictor', [(12, 1, 1), (14, 2, 1), (16, 2, 1),
                                                       (12, 1, 2), (16, 3, 2)])
def test_port_decodes_foreign_lossless_jpeg(precision, ncomp, predictor):
    s = np.random.default_rng(precision * ncomp).integers(0, 1 << min(precision, 13),
                                                          (5, 6, ncomp))
    stream = foreign_raw.encode_sof3(s, precision, predictor=predictor)
    for decode in (ljpeg.decode, ljpeg.decode_plain):
        out, prec = decode(stream)
        assert prec == precision
        np.testing.assert_array_equal(out, s)


def test_port_reads_a_foreign_lossless_jpeg_dng(tmp_path):
    m = capture(14, 12, h=6, w=8)
    payload = foreign_raw.encode_sof3(np.stack([m[:, 0::2], m[:, 1::2]], axis=-1), 14)
    path = tmp_path / 'c7.dng'
    path.write_bytes(foreign_raw.foreign_dng(m, bits=14, compression=7, pixel_data=payload))
    np.testing.assert_array_equal(dng.read_dng(str(path))['mosaic'], m)
    image = raw.process(str(path), device='cpu')
    assert tuple(image.shape) == (6, 8, 3) and bool(image.isfinite().all())


@pytest.mark.parametrize('name', ['truncated', 'not_tiff', 'compression'])
def test_port_rejects_what_the_reference_rejects(name, tmp_path):
    path = tmp_path / 'bad.dng'
    blob = foreign_raw.foreign_dng(capture(16, h=4, w=6), bits=16)
    if name == 'truncated':
        blob = blob[:-8]
    elif name == 'not_tiff':
        blob = b'XX' + blob[2:]
    else:
        blob = foreign_raw.foreign_dng(capture(16, h=4, w=6), bits=16, compression=34892)
    path.write_bytes(blob)
    with pytest.raises(jdng.DNGError):
        jdng.read_dng(str(path))
    with pytest.raises(dng.DNGError):
        dng.read_dng(str(path))
