"""
Baseline JPEG with libjpeg's bytes and pixels, without libjpeg: the host
codec behind the port's 'libjpeg' channel codec, ``jpeg_helpers`` and the
rate-distortion sweep.

:func:`encode` gives the file that PIL (libjpeg / libjpeg-turbo) writes for
``Image.fromarray(u8).save(buf, 'JPEG', quality=q, subsampling=s)``, byte for
byte, at every quality 1-100 and subsampling 4:4:4, 4:2:2 and 4:2:0;
:func:`decode` gives the pixels of ``Image.open(buf).convert('RGB')`` for any
baseline (or extended sequential) Huffman file of 1 or 3 components with
those samplings, optimized Huffman tables and restart intervals included.
Progressive and arithmetic-coded files raise ``NotImplementedError``.

Both run in the native codec ``csrc/baseline_jpeg.cpp``, built at first use
by ``utils/native.py`` into ``neural_imaging_tpu_torch/_build/`` and loaded
with ``ctypes``; a failed build raises. :func:`encode_plain` and
:func:`decode_plain` are the plain versions (numpy, with Python loops for the
entropy coder) the tests hold the native codec against; nothing else calls
them. ``PIL_DIGESTS`` are SHA-256 digests of PIL's files, and of the pixels
PIL decodes from them, for the seeded :func:`digest_images`: they let a
machine without PIL check the codec against libjpeg.
"""
import ctypes
import functools
import hashlib
import struct

import numpy as np

from neural_imaging_tpu_torch.ops.hopper._build import PACKAGE_DIR
from neural_imaging_tpu_torch.utils import native

SOURCE = PACKAGE_DIR / 'csrc' / 'baseline_jpeg.cpp'
SUBSAMPLING = {'4:4:4': 0, '4:2:2': 1, '4:2:0': 2}


def library_path():
    """Where the library built from ``csrc/baseline_jpeg.cpp`` lives."""
    return native.library_path(SOURCE, 'baseline_jpeg')


def build():
    """Compile the codec if its library is missing; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    return native.build(SOURCE, 'baseline_jpeg')


@functools.lru_cache()
def library():
    """The native codec: ``bj_encode``, ``bj_decode_info``, ``bj_decode`` and
    ``bj_error`` typed for ``ctypes``."""
    lib = ctypes.CDLL(str(build()))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bj_encode.restype = cl
    lib.bj_encode.argtypes = [vp, ci, ci, ci, ci, vp, cl]
    lib.bj_decode_info.restype = ci
    lib.bj_decode_info.argtypes = [ctypes.c_char_p, cl, ip, ip, ip]
    lib.bj_decode.restype = ci
    lib.bj_decode.argtypes = [ctypes.c_char_p, cl, vp, ci, ci]
    lib.bj_error.restype = ctypes.c_char_p
    lib.bj_error.argtypes = []
    return lib


def _subsampling_code(subsampling):
    """0, 1 or 2 from a name ('4:4:4', '4:2:2', '4:2:0') or that code."""
    if subsampling in (0, 1, 2):
        return int(subsampling)
    if subsampling not in SUBSAMPLING:
        raise ValueError(f'Unsupported subsampling {subsampling!r}: takes {list(SUBSAMPLING)}')
    return SUBSAMPLING[subsampling]


def _rgb_u8(image):
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f'Expected an (h, w, 3) uint8 image, got {image.dtype} {image.shape}')
    return np.ascontiguousarray(image)


def encode(image, quality=75, subsampling='4:4:4'):
    """The baseline JPEG file (bytes) of an (h, w, 3) uint8 RGB image."""
    image = _rgb_u8(image)
    h, w, _ = image.shape
    lib = library()
    cap = 4096 + 2 * image.size
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.bj_encode(image.ctypes.data, h, w, int(quality), _subsampling_code(subsampling),
                          out.ctypes.data, cap)
        if n < 0:
            raise ValueError(f'JPEG encoding failed: {lib.bj_error().decode()}')
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def decode(data):
    """The (h, w, 3) uint8 RGB pixels of a JPEG file (grayscale replicated)."""
    data = bytes(data)
    lib = library()
    h, w, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.bj_decode_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(nc)):
        raise ValueError(f'JPEG decoding failed: {lib.bj_error().decode()}')
    out = np.empty((h.value, w.value, 3), np.uint8)
    code = lib.bj_decode(data, len(data), out.ctypes.data, h.value, w.value)
    if code == -2:
        raise NotImplementedError(lib.bj_error().decode())
    if code:
        raise ValueError(f'JPEG decoding failed: {lib.bj_error().decode()}')
    return out


# ----------------------------------------------------------------------------------
# Plain version: numpy for the sample arithmetic, Python loops for the entropy coder
# ----------------------------------------------------------------------------------

# zigzag position -> natural (row-major) index
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 quantization tables (luma, chroma), natural order
STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5
    + [47, 66] + [99] * 6 + [99] * 32], dtype=np.int64)

# Annex K.3 Huffman tables: (code counts by length 1..16, symbols)
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), tuple(bytes.fromhex(
    '01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272'
    '82090a161718191a25262728292a3435363738393a434445464748494a53545556575859'
    '5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3'
    'a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2'
    'e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa')))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), tuple(bytes.fromhex(
    '000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1'
    '0a162434e125f11718191a'
    '262728292a35363738393a434445464748494a535455565758595a636465666768696a73'
    '7475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3'
    'b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3'
    'f4f5f6f7f8f9fa')))

CONST_BITS, PASS1_BITS = 13, 2
(FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865, FIX_0_899976223,
 FIX_1_175875602, FIX_1_501321110, FIX_1_847759065, FIX_1_961570560, FIX_2_053119869,
 FIX_2_562915447, FIX_3_072711026) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                                      16069, 16819, 20995, 25172)
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)
CBCR_OFFSET = 128 << SCALEBITS


def _fix16(x):
    return int(x * (1 << SCALEBITS) + 0.5)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def quant_tables(quality):
    """libjpeg's (luma, chroma) tables of a quality, clamped to 1..255
    (``jpeg_set_quality(q, force_baseline=TRUE)``), natural order: (2, 64)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((STD_QUANT * scale + 50) // 100, 1, 255)


def _fdct_1d(d, first):
    """One pass of the islow forward DCT along the last axis (int64)."""
    x = [d[..., i] for i in range(8)]
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, PASS1_BITS), _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4, tmp5 = tmp4 * FIX_0_298631336, tmp5 * FIX_2_053119869
    tmp6, tmp7 = tmp6 * FIX_3_072711026, tmp7 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=-1)


def _fdct(blocks):
    """islow forward DCT of (..., 8, 8) int64 blocks (output scaled by 8)."""
    rows = _fdct_1d(blocks, True)
    return _fdct_1d(rows.swapaxes(-1, -2), False).swapaxes(-1, -2)


def _idct_1d(d, first):
    """One pass of the islow inverse DCT along the last axis (int64)."""
    x = [d[..., i] for i in range(8)]
    z1 = (x[2] + x[6]) * FIX_0_541196100
    tmp2, tmp3 = z1 - x[6] * FIX_1_847759065, z1 + x[2] * FIX_0_765366865
    tmp0, tmp1 = (x[0] + x[4]) << CONST_BITS, (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0, tmp1 = tmp0 * FIX_0_298631336, tmp1 * FIX_2_053119869
    tmp2, tmp3 = tmp2 * FIX_3_072711026, tmp3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    s = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    return np.stack([_descale(v, s) for v in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)], axis=-1)


def _range_limit(v):
    """libjpeg's post-IDCT range limit: clamp(v + 128) for |v| < 512, wrapping
    modulo 1024 beyond."""
    i = v & 1023
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896)))


def _idct(coef, q):
    """islow inverse DCT of (..., 8, 8) coefficients dequantized by q (8, 8)."""
    cols = _idct_1d((coef.astype(np.int64) * q).swapaxes(-1, -2), True).swapaxes(-1, -2)
    return _range_limit(_idct_1d(cols, False)).astype(np.uint8)


def _rgb_to_ycc(rgb):
    r, g, b = (rgb[..., c].astype(np.int64) for c in range(3))
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b + ONE_HALF) >> SCALEBITS
    chroma = CBCR_OFFSET + ONE_HALF - 1
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + chroma) >> SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + chroma) >> SCALEBITS
    return y, cb, cr


def _ycc_to_rgb(y, cb, cr):
    x_cb, x_cr = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((_fix16(1.402) * x_cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix16(0.34414) * x_cb + ONE_HALF - _fix16(0.71414) * x_cr) >> SCALEBITS)
    b = y + ((_fix16(1.772) * x_cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _huffman_codes(spec):
    """{symbol: (code, length)} of a (counts, symbols) table."""
    counts, symbols = spec
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    """MSB-first bits with 0xFF stuffing, padded with 1-bits at the end."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, bits, size):
        self.acc = (self.acc << size) | (bits & ((1 << size) - 1))
        self.n += size
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        self.put(0x7F, 7)
        return bytes(self.out)


def _magnitude(v):
    """(size category, the value's bits) of a coefficient or DC difference."""
    size = int(abs(v)).bit_length()
    return size, (v - 1 if v < 0 else v)


def _encode_block(bw, block, pred, dc_codes, ac_codes):
    zz = block.reshape(64)[NATURAL]
    size, bits = _magnitude(int(zz[0]) - pred)
    if size > 11:
        raise ValueError('DCT coefficient out of range for baseline coding')
    bw.put(*dc_codes[size])
    bw.put(bits, size)
    run = 0
    for v in zz[1:].tolist():
        if v == 0:
            run += 1
            continue
        while run > 15:
            bw.put(*ac_codes[0xF0])
            run -= 16
        size, bits = _magnitude(v)
        if size > 10:
            raise ValueError('DCT coefficient out of range for baseline coding')
        bw.put(*ac_codes[(run << 4) + size])
        bw.put(bits, size)
        run = 0
    if run:
        bw.put(*ac_codes[0])
    return int(zz[0])


def _segment(marker, payload):
    return struct.pack('>HH', marker, len(payload) + 2) + payload


def _dht(cls_id, spec):
    counts, symbols = spec
    return _segment(0xFFC4, bytes([cls_id, *counts, *symbols]))


def encode_plain(image, quality=75, subsampling='4:4:4'):
    """:func:`encode` in numpy and Python: the same bytes, much slower."""
    image = _rgb_u8(image)
    h, w, _ = image.shape
    sub = _subsampling_code(subsampling)
    hmax, vmax = (1, 2, 2)[sub], (1, 1, 2)[sub]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    width, height = mcux * 8 * hmax, mcuy * 8 * vmax
    # edge replication to the MCU, then color conversion
    padded = image[np.minimum(np.arange(height), h - 1)][:, np.minimum(np.arange(width), w - 1)]
    planes = list(_rgb_to_ycc(padded))
    for c in (1, 2):
        if hmax == 1:
            continue
        p = planes[c]
        if vmax == 2:
            s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
            down = (s + 1 + np.arange(s.shape[1]) % 2) >> 2
        else:
            s = p[:, 0::2] + p[:, 1::2]
            down = (s + np.arange(s.shape[1]) % 2) >> 1
        rows = -(-h // vmax)        # rows below the image repeat its last downsampled row
        down[rows:] = down[rows - 1]
        planes[c] = down

    qt = quant_tables(quality)
    sampling = [(hmax, vmax), (1, 1), (1, 1)]
    coefs, blocks_with_data = [], []
    for c, plane in enumerate(planes):
        ph, pw = plane.shape
        blocks = (plane - 128).reshape(ph // 8, 8, pw // 8, 8).swapaxes(1, 2)
        d = _fdct(blocks)
        q8 = 8 * qt[min(c, 1)].reshape(8, 8)
        coefs.append(np.sign(d) * ((np.abs(d) + q8 // 2) // q8))
        hc, vc = sampling[c]
        blocks_with_data.append((-(-w * hc // (8 * hmax)), -(-h * vc // (8 * vmax))))

    header = b'\xff\xd8' + _segment(0xFFE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')
    for t in range(2):
        header += _segment(0xFFDB, bytes([t]) + bytes(qt[t][NATURAL].tolist()))
    header += _segment(0xFFC0, struct.pack('>BHHB', 8, h, w, 3) + bytes(
        [1, (hmax << 4) | vmax, 0, 2, 0x11, 1, 3, 0x11, 1]))
    header += (_dht(0x00, DC_LUMA) + _dht(0x10, AC_LUMA) + _dht(0x01, DC_CHROMA)
               + _dht(0x11, AC_CHROMA))
    header += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))

    tables = [(_huffman_codes(DC_LUMA), _huffman_codes(AC_LUMA)),
              (_huffman_codes(DC_CHROMA), _huffman_codes(AC_CHROMA))]
    bw = _BitWriter()
    preds = [0, 0, 0]
    zero = np.zeros((8, 8), np.int64)
    for my in range(mcuy):
        for mx in range(mcux):
            for c in range(3):
                hc, vc = sampling[c]
                bw_c, bh_c = blocks_with_data[c]
                mcu = []
                for yi in range(vc):
                    for xi in range(hc):
                        by, bx = my * vc + yi, mx * hc + xi
                        if by >= bh_c:             # a dummy row: the DC of the block before
                            blk = zero.copy()
                            blk[0, 0] = mcu[yi * hc - 1][0, 0]
                        elif bx >= bw_c:           # a dummy column: its left neighbor's DC
                            blk = zero.copy()
                            blk[0, 0] = mcu[-1][0, 0]
                        else:
                            blk = coefs[c][by, bx]
                        mcu.append(blk)
                for blk in mcu:
                    preds[c] = _encode_block(bw, blk, preds[c], *tables[min(c, 1)])
    return header + bw.flush() + b'\xff\xd9'


class _BitReader:
    """MSB-first bits of entropy-coded data: 0xFF00 unstuffed, zeros past a marker."""

    def __init__(self, data, pos):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.n = 0
        self.at_marker = False

    def bit(self):
        if self.n == 0:
            byte = 0
            if not self.at_marker and self.pos < len(self.data):
                byte = self.data[self.pos]
                if byte == 0xFF:
                    q = self.pos + 1
                    while q < len(self.data) and self.data[q] == 0xFF:
                        q += 1
                    if q < len(self.data) and self.data[q] == 0:
                        self.pos = q + 1
                    else:
                        self.at_marker, self.pos, byte = True, q - 1, 0
                else:
                    self.pos += 1
            self.acc, self.n = byte, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def restart(self):
        """Drop the buffered bits and step over the restart marker that follows."""
        self.n = 0
        data = self.data
        if not self.at_marker:
            while self.pos + 1 < len(data) and not (data[self.pos] == 0xFF
                                                    and data[self.pos + 1] not in (0, 0xFF)):
                self.pos += 1
        self.at_marker = False
        if self.pos + 1 < len(data) and 0xD0 <= data[self.pos + 1] <= 0xD7:
            self.pos += 2


def _decode_table(counts, symbols):
    """{(length, code): symbol} of a Huffman table."""
    codes = _huffman_codes((counts, symbols))
    return {(length, code): s for s, (code, length) in codes.items()}


def _read_symbol(br, table):
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.bit()
        symbol = table.get((length, code))
        if symbol is not None:
            return symbol
    raise ValueError('JPEG decoding failed: corrupt JPEG data: bad Huffman code')


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_block(br, dc_table, ac_table, pred):
    block = np.zeros(64, np.int64)
    s = _read_symbol(br, dc_table)
    pred += _extend(br.bits(s), s) if s else 0
    block[0] = pred
    k = 1
    while k < 64:
        rs = _read_symbol(br, ac_table)
        r, size = rs >> 4, rs & 15
        if size:
            k += r
            if k > 63:
                break
            block[NATURAL[k]] = _extend(br.bits(size), size)
        elif r != 15:
            break
        else:
            k += 15
        k += 1
    return block.reshape(8, 8), pred


def _upsample_h2(s, dw, rows, dh, vmax):
    """Fancy (triangle-filter) h2v1 / h2v2 upsampling of the downsampled
    plane ``s`` (its first ``dh`` rows and ``dw`` columns hold data) to
    ``rows`` rows of 2 * dw columns; box upsampling when dw <= 2."""
    y = np.arange(rows)
    sy = y // vmax
    if dw <= 2:
        return np.repeat(s[sy][:, :dw], 2, axis=1)
    in0 = s[sy, :dw].astype(np.int64)
    out = np.empty((rows, 2 * dw), np.int64)
    if vmax == 1:
        out[:, 0] = in0[:, 0]
        out[:, 2::2] = (3 * in0[:, 1:] + in0[:, :-1] + 1) >> 2
        out[:, 1:-1:2] = (3 * in0[:, :-1] + in0[:, 1:] + 2) >> 2
        out[:, -1] = in0[:, -1]
        return out
    near = np.where(y % 2, np.minimum(sy + 1, dh - 1), np.maximum(sy - 1, 0))
    col = 3 * in0 + s[near, :dw].astype(np.int64)
    out[:, 0] = (4 * col[:, 0] + 8) >> 4
    out[:, 2::2] = (3 * col[:, 1:] + col[:, :-1] + 8) >> 4
    out[:, 1:-1:2] = (3 * col[:, :-1] + col[:, 1:] + 7) >> 4
    out[:, -1] = (4 * col[:, -1] + 7) >> 4
    return out


def decode_plain(data):
    """:func:`decode` in numpy and Python: the same pixels, much slower."""
    data = bytes(data)
    if data[:2] != b'\xff\xd8':
        raise ValueError('JPEG decoding failed: not a JPEG file: no SOI marker')
    qt, dc_tables, ac_tables = {}, {}, {}
    frame, restart_interval = None, 0
    saw_jfif, adobe_transform = False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if marker == 0xD8 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        seglen = struct.unpack('>H', data[pos:pos + 2])[0]
        seg, pos = data[pos + 2:pos + seglen], pos + seglen
        if marker in (0xC0, 0xC1):
            if seg[0] != 8:
                raise NotImplementedError('only 8-bit JPEG files are supported')
            h, w, nc = struct.unpack('>HHB', seg[1:6])
            if nc not in (1, 3):
                raise NotImplementedError('only 1- and 3-component JPEG files are supported')
            comps = [{'id': seg[6 + 3 * i], 'h': seg[7 + 3 * i] >> 4, 'v': seg[7 + 3 * i] & 15,
                      'tq': seg[8 + 3 * i]} for i in range(nc)]
            if nc == 1:
                comps[0]['h'] = comps[0]['v'] = 1
            hmax, vmax = max(c['h'] for c in comps), max(c['v'] for c in comps)
            if nc == 3 and (any(c['h'] != 1 or c['v'] != 1 for c in comps[1:])
                            or (hmax, vmax) not in ((1, 1), (2, 1), (2, 2))):
                raise NotImplementedError('only 4:4:4, 4:2:2 and 4:2:0 sampling are supported')
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c['bw'], c['bh'] = -(-w * c['h'] // (8 * hmax)), -(-h * c['v'] // (8 * vmax))
                c['coef'] = np.zeros((mcuy * c['v'], mcux * c['h'], 8, 8), np.int64)
            frame = (h, w, hmax, vmax, mcux, mcuy, comps)
        elif marker in (0xC2, 0xC6, 0xCA, 0xCE):
            raise NotImplementedError('Progressive JPEG images are not supported')
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError('only baseline / extended sequential Huffman JPEG files '
                                      'are supported')
        elif marker == 0xC4:
            while seg:
                counts = tuple(seg[1:17])
                table = _decode_table(counts, tuple(seg[17:17 + sum(counts)]))
                (ac_tables if seg[0] >> 4 else dc_tables)[seg[0] & 15] = table
                seg = seg[17 + sum(counts):]
        elif marker == 0xDB:
            while seg:
                wide = seg[0] >> 4
                n = 64 * (wide + 1)
                vals = (struct.unpack('>64H', seg[1:1 + n]) if wide else tuple(seg[1:1 + n]))
                table = np.zeros(64, np.int64)
                table[NATURAL] = vals
                qt[seg[0] & 15] = table.reshape(8, 8)
                seg = seg[1 + n:]
        elif marker == 0xDD:
            restart_interval = struct.unpack('>H', seg[:2])[0]
        elif marker == 0xE0 and seg[:5] == b'JFIF\x00':
            saw_jfif = True
        elif marker == 0xEE and seg[:5] == b'Adobe' and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError('JPEG decoding failed: SOS before SOF')
            pos = _decode_scan(data, pos, seg, frame, dc_tables, ac_tables, restart_interval)
    if frame is None:
        raise ValueError('JPEG decoding failed: no frame header')
    h, w, hmax, vmax, mcux, mcuy, comps = frame
    planes = []
    for c in comps:
        pix = _idct(c['coef'], qt[c['tq']])                   # (bh, bw, 8, 8)
        planes.append(pix.swapaxes(1, 2).reshape(pix.shape[0] * 8, pix.shape[1] * 8))
    if len(comps) == 1:
        return np.repeat(planes[0][:h, :w, None], 3, axis=2)
    y = planes[0][:h, :w]
    chroma = []
    for p in planes[1:]:
        if hmax == 1:
            chroma.append(p[:h, :w])
        else:
            chroma.append(_upsample_h2(p, -(-w // 2), h, -(-h // vmax), vmax)[:, :w])
    # libjpeg's guess: JFIF means YCbCr, else Adobe's transform, else ids 'R', 'G', 'B'
    rgb = not saw_jfif and (adobe_transform == 0 if adobe_transform is not None else
                            [c['id'] for c in comps] == [82, 71, 66])
    if rgb:
        return np.stack([y, chroma[0], chroma[1]], -1).astype(np.uint8)
    return _ycc_to_rgb(y, chroma[0], chroma[1])


def _decode_scan(data, pos, seg, frame, dc_tables, ac_tables, restart_interval):
    """Decode one scan's blocks into its components' ``coef``; returns the
    position of the marker after its entropy-coded data."""
    _, _, _, _, mcux, mcuy, comps = frame
    ns = seg[0]
    scan = []
    for i in range(ns):
        comp = next(c for c in comps if c['id'] == seg[1 + 2 * i])
        scan.append((comp, dc_tables[seg[2 + 2 * i] >> 4], ac_tables[seg[2 + 2 * i] & 15]))
    br = _BitReader(data, pos)
    preds = [0] * ns
    if ns == 1:
        per_row, n_mcu = scan[0][0]['bw'], scan[0][0]['bw'] * scan[0][0]['bh']
    else:
        per_row, n_mcu = mcux, mcux * mcuy
    to_restart = restart_interval
    for m in range(n_mcu):
        if restart_interval:
            if to_restart == 0:
                br.restart()
                preds = [0] * ns
                to_restart = restart_interval
            to_restart -= 1
        my, mx = divmod(m, per_row)
        for i, (comp, dc, ac) in enumerate(scan):
            if ns == 1:
                comp['coef'][my, mx], preds[i] = _decode_block(br, dc, ac, preds[i])
                continue
            for yi in range(comp['v']):
                for xi in range(comp['h']):
                    by, bx = my * comp['v'] + yi, mx * comp['h'] + xi
                    comp['coef'][by, bx], preds[i] = _decode_block(br, dc, ac, preds[i])
    pos = br.pos
    while pos + 1 < len(data) and not (data[pos] == 0xFF and data[pos + 1] != 0
                                       and not 0xD0 <= data[pos + 1] <= 0xD7):
        pos += 1
    return pos


# ----------------------------------------------------------------------------------
# libjpeg's files of seeded images, as SHA-256 digests
# ----------------------------------------------------------------------------------

def digest_images():
    """{name: (h, w, 3) uint8} images made from seeds with numpy alone: the
    inputs of ``PIL_DIGESTS``."""
    rng = np.random.default_rng(2024)
    yy, xx = np.mgrid[0:45, 0:70]
    ramp = np.stack([(3 * xx + 2 * yy) % 256, (5 * yy) % 256, (xx * yy) % 256], -1)
    return {'noise_37x53': rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
            'ramp_45x70': ramp.astype(np.uint8),
            'blocks_64x96': np.kron(rng.integers(0, 256, (8, 12, 3)), np.ones((8, 8, 1)))
            .astype(np.uint8)}


def sha256(data):
    return hashlib.sha256(bytes(data)).hexdigest()


# {(image, quality, subsampling): (digest of PIL's file, digest of the pixels PIL decodes from it)}
PIL_DIGESTS = {
    ('noise_37x53', 20, '4:4:4'): ('26848a0961787af3b9d4a40f3f0007c1a0ddb813f9407b61a06765b099f7a139',
                              '85e29b023b0986c37d334e43e0a9a36f573595918b674b7d2d25f6dcc9e3d238'),
    ('noise_37x53', 20, '4:2:2'): ('7148700d706240b09831c81758fd95268c4270b21748c6309bcafd042b6e0d7b',
                              'a2da03cdb3eb477f29bef1757863ea5ef805473df77c28cbae35ea9a925d90d0'),
    ('noise_37x53', 20, '4:2:0'): ('8e4cfc923065897e0fa6c2442493ae5b981269f286a48bfd4490e7d3d315e050',
                              'a5b104e94006c7a8c50fbee517e701c945bb98a36e50b33570a8780dcf396460'),
    ('noise_37x53', 90, '4:4:4'): ('631e37c60fffc0f86e9b7517b40707a38e14157d20bc5f4a5a500dd9b6d683e6',
                              '4766812044228d4f328b26dde5d4f874ff25eb4bb5ba37a60355bf3d3633a62c'),
    ('noise_37x53', 90, '4:2:2'): ('9de1666c38c049831fe1e6cd1655075c455b8093b0df21c681b92e1abaac4a12',
                              'e57f5429484d0e3e401a53102d6f64880c7d1c952ee3faebddc5310f6e908f0a'),
    ('noise_37x53', 90, '4:2:0'): ('197af9156b6f6b5ae46add5f99ef04524f930a6ea17400a3204b63adb50e9a10',
                              'ded82376ef8b647b152490ae11fa8e4c02afe2dfc64bd30c750df5daf0add794'),
    ('ramp_45x70', 20, '4:4:4'): ('dc0cff3834f5ff9595ed69b1e1a34d08a6ac73550fb2ee0cc04bc6b9241c96ae',
                             'a3146925cc0857075a6e3bd2f9237acf55a5b289fbb84ffe57f8362baeac594f'),
    ('ramp_45x70', 20, '4:2:2'): ('94533d697aec324274d5de0b38e76bd3e9762826d490e2d49c0d5d13683502f6',
                             '0b51936d5aea8f5be32a2641dec816366309641550a89acb5b6c6b1915e7b4ab'),
    ('ramp_45x70', 20, '4:2:0'): ('afed63568856b5d16a1a3b9ca192d169e99947d1c46db6b08b05a52dc0374ac2',
                             'fe0a4ddd277116b2634d1c454144456a6439d4c8653de036fbd50114f253bf2c'),
    ('ramp_45x70', 90, '4:4:4'): ('6488f8add79c3b19c8ea766a8d2b6788ec4e123a5fe8948fde6e492b83e984c0',
                             '059536c5c1fed5fb26d9aa8dd3c4ff9a08a33ead80ef1cf208266ed1f86a2008'),
    ('ramp_45x70', 90, '4:2:2'): ('df5d6a0c66d5fa1d84e4736dbc01aee0a0678b2f4f6e1e3ac3b6287b4102ef08',
                             '03eb4dd12c50608c4f38dc6aa592cdae0f93bd8ee07139871fd5cf3629e48cbb'),
    ('ramp_45x70', 90, '4:2:0'): ('0ae97b77152a3154ed1d98f093cc751894a27486c9ab2b407e8376f617862582',
                             '6ac77bdaad15f2475cd7951407fa4506423f9166fd34959cd1dcfbedc608d9bb'),
    ('blocks_64x96', 20, '4:4:4'): ('5cf33ea22ed4098de4e3d49eae02fb57ff2752997292b66a7fa8cab49c41a5af',
                               'b6b7398db0345d3c1b9c9cffeffbf643b97c0f17d7350dc9674909bc97dd487c'),
    ('blocks_64x96', 20, '4:2:2'): ('45b4dfcddf3b75a0d22356ebb2cbbce82342d14e9c930eebab31b6fa4f14863f',
                               'c16efeb84a42cce9a217112cc311a0e77a167fe9ba81d3e1cdbe80791bf266ce'),
    ('blocks_64x96', 20, '4:2:0'): ('6bddcf0a6d98be08897e62f76bbdf372d15310735e34841f98a5d44254f29f46',
                               '30ea90e69b9551cbf3fc2d745b8df6ea83c35e2d31d7c7c184113340f66dd24d'),
    ('blocks_64x96', 90, '4:4:4'): ('34e216442b8fd53eec82b68091dd822b88be62d4de1177a5bbcd1d2eab1ef3d2',
                               '64b492cdb6a67da7230765ec0728a029e207d95a173cd6619890923cd2520200'),
    ('blocks_64x96', 90, '4:2:2'): ('5d577511b32b100d5fcc380b68fe7bc2d19a06ef46cabe40a6df2e0d645a5fee',
                               'e0137ce56635e6ed7d3faaff476de72aa640eff3c22874781c831698c9350715'),
    ('blocks_64x96', 90, '4:2:0'): ('b89034a0bdaa0d04108269e2114f7b9e5e1282c5da5a31df7a92246eac4bada4',
                               '55bc2ab68f0d7456cb77601fc180a889fe6f4263ffb8821b1cc81cfea58a00a6'),
}


def digest_mismatches(encode_fn=encode, decode_fn=decode):
    """The ``PIL_DIGESTS`` entries a codec does not reproduce: [(key, 'bytes'
    or 'pixels')]; pixels are decoded from PIL's file as the codec wrote it."""
    images = digest_images()
    wrong = []
    for key, (file_digest, pixel_digest) in PIL_DIGESTS.items():
        name, quality, subsampling = key
        data = encode_fn(images[name], quality, subsampling)
        if sha256(data) != file_digest:
            wrong.append((key, 'bytes'))
        elif sha256(np.ascontiguousarray(decode_fn(data))) != pixel_digest:
            wrong.append((key, 'pixels'))
    return wrong
