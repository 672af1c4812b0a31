"""The port's native lossless-JPEG and Nikon codecs (``native/ljpeg/ljpeg.cpp``
built with g++ into ``neural_imaging_tpu_torch/_build/``) against the port's
Python scan loops (their plain versions) and the JAX package's
``ljpeg.decode`` / ``encode`` and ``nikon.decode``: bytes and samples exact.
A failed build raises with the compiler's output; nothing falls back."""
import numpy as np
import pytest

from neural_imaging_tpu.data import ljpeg as jljpeg
from neural_imaging_tpu.data import nikon as jnikon
from neural_imaging_tpu_torch.data import ljpeg, nikon
from neural_imaging_tpu_torch.utils import native

SHAPES = [((1, 1, 1), 8), ((7, 5, 1), 12), ((9, 13, 2), 14), ((16, 24, 2), 16),
          ((5, 6, 3), 16), ((4, 3, 4), 10)]


def samples(shape, precision, seed, kind):
    rng = np.random.default_rng(seed)
    hi = (1 << precision) - 1
    if kind == 'noise':
        return rng.integers(0, hi + 1, shape).astype(np.uint16)
    if kind == 'extremes':                       # full-range jumps: SSSS up to 16
        s = np.zeros(shape, np.uint16)
        s[..., ::2, :] = hi
        return s
    ramp = np.cumsum(rng.integers(-3, 4, shape), axis=1) + hi // 2
    return np.clip(ramp, 0, hi).astype(np.uint16)


@pytest.mark.parametrize('kind', ['noise', 'extremes', 'smooth'])
@pytest.mark.parametrize('shape,precision', SHAPES)
def test_ljpeg_codes_as_the_plain_loops_and_the_reference(shape, precision, kind):
    s = samples(shape, precision, sum(shape), kind)
    stream = ljpeg.encode(s, precision=precision)
    assert stream == ljpeg.encode_plain(s, precision=precision)
    assert stream == jljpeg.encode(s, precision=precision)
    for decode in (ljpeg.decode, ljpeg.decode_plain, jljpeg.decode):
        out, prec = decode(stream)
        assert prec == precision and out.dtype == np.uint16
        np.testing.assert_array_equal(out, s)


@pytest.mark.parametrize('predictor', range(1, 8))
def test_ljpeg_decoders_agree_for_every_predictor(predictor):
    """A stream re-labelled with another predictor decodes to other samples,
    the same in the native, the plain and the reference decoder."""
    s = samples((6, 9, 2), 12, predictor, 'smooth')
    stream = bytearray(ljpeg.encode(s, precision=12))
    sos = stream.index(b'\xff\xda')
    ns = stream[sos + 4]
    stream[sos + 5 + 2 * ns] = predictor           # Ss: the predictor selection
    stream = bytes(stream)
    native_out, _ = ljpeg.decode(stream)
    np.testing.assert_array_equal(native_out, ljpeg.decode_plain(stream)[0])
    np.testing.assert_array_equal(native_out, jljpeg.decode(stream)[0])
    if predictor == 1:
        np.testing.assert_array_equal(native_out, s)


def test_ljpeg_rejects_what_is_not_lossless_jpeg():
    with pytest.raises(ljpeg.LJpegError, match='SOI'):
        ljpeg.decode(b'\x00\x01' + b'\x00' * 20)
    with pytest.raises(ljpeg.LJpegError, match='SOF3'):
        ljpeg.decode(b'\xff\xd8\xff\xda\x00\x08\x01\x01\x00\x01\x00\x00')
    with pytest.raises(ljpeg.LJpegError, match='predictor 1'):
        ljpeg.encode(np.zeros((2, 2), np.uint16), predictor=2)


def _nikon_streams():
    m14 = samples((12, 20), 14, 1, 'smooth')
    m12 = samples((9, 16), 12, 2, 'noise')
    full_curve = np.round(4095 * (np.arange(4097) / 4096) ** 1.5).astype(np.uint16)
    out = {}
    for name, m, bits in (('lossless14', m14, 14), ('lossless12', m12, 12)):
        payload, meta = nikon.encode(m, bits)
        out[name] = (payload, m.shape, bits, meta, m)
    for name, m, bits, kw in (
            ('lossy14', m14, 14, {}),
            ('lossy14_split', m14, 14, dict(split=5)),
            ('lossy12_split', m12, 12, dict(split=1)),
            ('lossy12_curve', m12, 12, dict(full_curve=full_curve))):
        payload, recon, vpred = nikon.encode_lossy(m, bits, split=kw.get('split', 0))
        if 'full_curve' in kw:
            meta = nikon.build_meta_lossy(vpred, full_curve=kw['full_curve'])
        elif kw.get('split'):
            step = ((1 << bits) & 0x7FFF) // 16
            meta = nikon.build_meta_lossy(vpred, curve_samples=np.arange(17) * step,
                                          split=kw['split'])
        else:
            meta = nikon.build_meta_lossy(vpred)
        out[name] = (payload, m.shape, bits, meta, recon)
    return out


NIKON = _nikon_streams()


@pytest.mark.parametrize('name', sorted(NIKON))
def test_nikon_decodes_as_the_plain_loop_and_the_reference(name):
    payload, (h, w), bits, meta, recon = NIKON[name]
    out = nikon.decode(payload, h, w, bits, meta)
    np.testing.assert_array_equal(out, nikon.decode_plain(payload, h, w, bits, meta))
    np.testing.assert_array_equal(out, jnikon.decode(payload, h, w, bits, meta))
    curve = nikon.parse_meta(meta, bits=bits)['curve']
    want = recon if curve is None else curve[np.clip(recon, 0, len(curve) - 1)]
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize('bits', [12, 14])
def test_nikon_encoders_write_the_reference_bytes(bits):
    m = samples((10, 14), bits, bits, 'noise')
    assert nikon.encode(m, bits) == jnikon.encode(m, bits)
    for split in (0, 3):
        port, ref = nikon.encode_lossy(m, bits, split), jnikon.encode_lossy(m, bits, split)
        assert port[0] == ref[0] and port[2] == ref[2]


def test_nikon_bit_packing_is_the_reference_packing():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 1001):
        lengths = rng.integers(0, 17, n)
        values = rng.integers(0, 1 << 16, n).astype(np.uint32)
        assert nikon._pack_bits(values, lengths) == jnikon._pack_bits(values, lengths)


def test_library_is_built_from_the_source_into_the_build_directory():
    path = ljpeg.build()
    assert path == ljpeg.library_path() and path.exists()
    assert path.parent.name == '_build' and path.name.startswith('libljpeg-')
    assert '-march=native' not in native.CXX_FLAGS
    assert ljpeg.library().ljpeg_decode_scan is not None


def test_a_failed_build_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('int main( {\n')
    with pytest.raises(RuntimeError, match='g\\+\\+ exited') as info:
        native.build(bad, 'broken')
    assert 'broken.cpp' in str(info.value)
    assert not native.library_path(bad, 'broken').exists()
