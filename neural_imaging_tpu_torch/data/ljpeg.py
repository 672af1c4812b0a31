"""
Lossless JPEG (ITU-T T.81 process 14, SOF3): the entropy coding of compressed
CFA DNGs and of most camera RAW payloads (CR2, lossless NEF and ARW). Copy of
``neural_imaging_tpu/data/ljpeg.py``.

- :func:`decode` parses an SOF3 stream (DHT/SOF3/SOS/DRI, interleaved multi-
  component scans, predictors 1-7, point transform, restart markers, byte
  stuffing) into an (lines, samples, components) uint16 array.
- :func:`encode` writes a conformant stream (predictor 1, one optimal
  Huffman table shared by all components).

The per-sample scan loops run in the native codec ``native/ljpeg/ljpeg.cpp``,
built at first use by ``utils/native.py`` into ``neural_imaging_tpu_torch/
_build/`` and loaded with ``ctypes``; a failed build raises. The Python
scan loops (:func:`decode_plain`, :func:`encode_plain`, the bit reader and
writer) are the plain versions the tests hold the native codec against;
nothing else calls them.
"""
import ctypes
import functools
import struct

import numpy as np

from neural_imaging_tpu_torch.models.base import REPO_ROOT
from neural_imaging_tpu_torch.utils import native

SOURCE = REPO_ROOT / 'native' / 'ljpeg' / 'ljpeg.cpp'


def library_path():
    """Where the library built from ``native/ljpeg/ljpeg.cpp`` lives."""
    return native.library_path(SOURCE, 'ljpeg')


def build():
    """Compile the scan codec if its library is missing; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    return native.build(SOURCE, 'ljpeg')


@functools.lru_cache()
def library():
    """The native scan codec: ``ljpeg_decode_scan``, ``ljpeg_encode_scan``
    and ``nikon_decode_scan`` typed for ``ctypes``."""
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ljpeg_decode_scan.restype = ctypes.c_int
    lib.ljpeg_decode_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int, u8p, u8p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i32p]
    lib.ljpeg_encode_scan.restype = ctypes.c_int
    lib.ljpeg_encode_scan.argtypes = [
        i32p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint32), u8p,
        u8p, ctypes.c_int]
    lib.nikon_decode_scan.restype = ctypes.c_int
    lib.nikon_decode_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        u8p, u8p, ctypes.c_int,
        u8p, u8p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16)]
    return lib


# JPEG markers
_SOI, _EOI = 0xFFD8, 0xFFD9
_SOF3 = 0xFFC3
_DHT = 0xFFC4
_SOS = 0xFFDA
_DRI = 0xFFDD
_RST0 = 0xFFD0


class LJpegError(ValueError):
    pass


# ----------------------------------------------------------------------------------
# Bit IO
# ----------------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over entropy-coded JPEG data with 0xFF00 unstuffing."""

    __slots__ = ('data', 'pos', 'acc', 'nbits')

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        data = self.data
        while self.nbits <= 24:
            if self.pos >= len(data):
                self.acc = (self.acc << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            byte = data[self.pos]
            if byte == 0xFF:
                nxt = data[self.pos + 1] if self.pos + 1 < len(data) else 0xD9
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:  # restart marker: caller resyncs
                    self.acc = (self.acc << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
                else:  # EOI or next segment — pad with zeros
                    self.acc = (self.acc << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
            else:
                self.pos += 1
            self.acc = ((self.acc << 8) | byte) & 0xFFFFFFFF
            self.nbits += 8

    def peek16(self):
        if self.nbits < 16:
            self._fill()
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n):
        self.nbits -= n

    def read(self, n):
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def resync(self):
        """Skip to just past the next restart marker and clear the bit buffer."""
        data = self.data
        # drop whole buffered bytes, then scan
        self.pos -= self.nbits // 8
        self.acc = 0
        self.nbits = 0
        i = self.pos
        while i + 1 < len(data):
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
                self.pos = i + 2
                return
            i += 1
        raise LJpegError('Expected a restart marker, none found')


class _BitWriter:
    __slots__ = ('chunks', 'acc', 'nbits')

    def __init__(self):
        self.chunks = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value, n):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.chunks.append(byte)
            if byte == 0xFF:
                self.chunks.append(0x00)  # byte stuffing

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)  # pad with 1s per spec
        return bytes(self.chunks)


# ----------------------------------------------------------------------------------
# Huffman tables
# ----------------------------------------------------------------------------------

def _canonical_codes(bits, values):
    """(BITS[1..16], HUFFVAL) -> {value: (code, length)} (Annex C)."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _decode_table(bits, values):
    """Fast decode LUT: 16-bit lookahead -> (value, code_length)."""
    lut_val = np.zeros(1 << 16, dtype=np.int16)
    lut_len = np.zeros(1 << 16, dtype=np.int8)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            prefix = code << (16 - length)
            span = 1 << (16 - length)
            lut_val[prefix:prefix + span] = values[k]
            lut_len[prefix:prefix + span] = length
            code += 1
            k += 1
        code <<= 1
    return lut_val, lut_len


# Fallback encoder table for SSSS symbols 0..16: short codes for small magnitudes.
_ENC_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
_ENC_VALUES = list(range(17))


def _optimal_table(counts):
    """Optimal length-limited Huffman table for the SSSS histogram (the Annex
    K.2/K.3 procedure, as in libjpeg's jpeg_gen_optimal_table): returns
    (BITS[1..16], HUFFVAL). A dummy symbol guarantees the all-1s code stays
    unassigned."""
    n_sym = 17
    freq = [0] * (n_sym + 1)
    for s, c in counts.items():
        freq[int(s)] = int(c)
    freq[n_sym] = 1  # dummy: reserves the all-ones code

    codesize = [0] * (n_sym + 1)
    others = [-1] * (n_sym + 1)
    while True:
        # two least-frequent nonzero entries (ties -> larger symbol, per spec)
        c1 = c2 = -1
        v1 = v2 = 1 << 60
        for i in range(n_sym + 1):
            if freq[i] and freq[i] <= v1:
                v1, c1 = freq[i], i
        for i in range(n_sym + 1):
            if freq[i] and freq[i] <= v2 and i != c1:
                v2, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1

    bits = [0] * 33
    for i in range(n_sym + 1):
        if codesize[i]:
            bits[codesize[i]] += 1
    # limit code lengths to 16 (K.3 adjust_bits)
    for length in range(32, 16, -1):
        while bits[length]:
            j = length - 2
            while bits[j] == 0:
                j -= 1
            bits[length] -= 2
            bits[length - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # remove the dummy symbol's (longest) code
    for length in range(16, 0, -1):
        if bits[length]:
            bits[length] -= 1
            break

    huffval = [s for s in sorted(range(n_sym), key=lambda s: (codesize[s], s))
               if codesize[s]]
    return bits[1:17], huffval


def _extend(bits, ssss):
    """Sign-extend SSSS magnitude bits to a signed difference (F.2.2.1)."""
    if ssss == 0:
        return 0
    if bits < (1 << (ssss - 1)):
        return bits - (1 << ssss) + 1
    return bits


# ----------------------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------------------

def _predict(ra, rb, rc, predictor, point_transform, precision):
    if predictor == 1:
        return ra
    if predictor == 2:
        return rb
    if predictor == 3:
        return rc
    if predictor == 4:
        return ra + rb - rc
    if predictor == 5:
        return ra + ((rb - rc) >> 1)
    if predictor == 6:
        return rb + ((ra - rc) >> 1)
    if predictor == 7:
        return (ra + rb) >> 1
    if predictor == 0:
        return 0
    raise LJpegError(f'Unsupported predictor {predictor}')


def _parse(stream):
    """Parse the markers of an SOF3 stream up to its scan: (lines, width,
    precision, predictor, point transform, restart interval, the Huffman
    table (BITS, HUFFVAL) of each scan component, the entropy-coded bytes)."""
    data = memoryview(bytes(stream))
    if struct.unpack_from('>H', data, 0)[0] != _SOI:
        raise LJpegError('Not a JPEG stream (missing SOI)')

    pos = 2
    huff = {}
    precision = lines = width = None
    comps = []
    restart_interval = 0

    while True:
        (marker,) = struct.unpack_from('>H', data, pos)
        pos += 2
        if marker == _EOI:
            raise LJpegError('EOI before SOS — no scan data')
        (seg_len,) = struct.unpack_from('>H', data, pos)
        seg = bytes(data[pos + 2:pos + seg_len])
        if marker == _DHT:
            p = 0
            while p < len(seg):
                tc_th = seg[p]
                bits = list(seg[p + 1:p + 17])
                n = sum(bits)
                values = list(seg[p + 17:p + 17 + n])
                huff[tc_th & 0x0F] = (bits, values)
                p += 17 + n
        elif marker == _SOF3:
            precision = seg[0]
            lines, width = struct.unpack_from('>HH', seg, 1)
            nf = seg[5]
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i])
                     for i in range(nf)]  # (id, sampling, tq)
        elif (marker & 0xFF00) == 0xFFC0 and marker != _DHT:
            raise LJpegError(f'Not a lossless (SOF3) JPEG: frame marker {marker:#x}')
        elif marker == _DRI:
            (restart_interval,) = struct.unpack_from('>H', seg, 0)
        elif marker == _SOS:
            ns = seg[0]
            scan_comps = [(seg[1 + 2 * i], seg[2 + 2 * i]) for i in range(ns)]
            predictor = seg[1 + 2 * ns]          # Ss = predictor selection
            point_transform = seg[3 + 2 * ns] & 0x0F  # Al
            pos += seg_len
            break
        pos += seg_len

    if precision is None:
        raise LJpegError('Missing SOF3 frame header')
    if any(s != 0x11 for _, s, _ in comps):
        raise LJpegError('Subsampled lossless scans are not supported')

    raw_tables = []
    for cid, td_ta in scan_comps:
        td = (td_ta >> 4) & 0x0F
        if td not in huff:
            raise LJpegError(f'Missing Huffman table {td}')
        raw_tables.append(huff[td])
    return (lines, width, precision, predictor, point_transform, restart_interval,
            raw_tables, bytes(data[pos:]))


def decode(stream):
    """Decode an SOF3 stream with the native scan codec; returns (samples
    array (lines, width, comps) uint16, precision)."""
    (lines, width, precision, predictor, point_transform, restart_interval,
     raw_tables, scan_bytes) = _parse(stream)
    ncomp = len(raw_tables)
    # deduplicate tables, map each component to its table slot
    uniq, comp_idx = [], []
    for t in raw_tables:
        if t not in uniq:
            uniq.append(t)
        comp_idx.append(uniq.index(t))
    bits16 = np.zeros(16 * len(uniq), np.uint8)
    huffval = np.zeros(17 * len(uniq), np.uint8)
    sizes = np.zeros(len(uniq), np.int32)
    for t, (bits, values) in enumerate(uniq):
        bits16[16 * t:16 * t + 16] = bits
        huffval[17 * t:17 * t + len(values)] = values
        sizes[t] = len(values)
    out = np.zeros((lines, width, ncomp), dtype=np.int32)
    comp_idx = np.asarray(comp_idx, np.int32)
    rc = library().ljpeg_decode_scan(
        scan_bytes, len(scan_bytes),
        bits16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        huffval.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(uniq),
        comp_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), ncomp,
        lines, width, predictor, point_transform, precision,
        restart_interval,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise LJpegError(f'Malformed lossless-JPEG scan (native rc={rc})')
    return out.astype(np.uint16), precision


def decode_plain(stream):
    """:func:`decode` with the scan decoded by the Python loops (the plain
    version of the native codec)."""
    (lines, width, precision, predictor, point_transform, restart_interval,
     raw_tables, scan_bytes) = _parse(stream)
    ncomp = len(raw_tables)
    tables = [_decode_table(bits, values) for bits, values in raw_tables]
    out = np.zeros((lines, width, ncomp), dtype=np.int32)
    reader = _BitReader(scan_bytes, 0)

    default_pred = 1 << (precision - point_transform - 1)
    mcu_count = 0
    mcus_per_restart = restart_interval

    for y in range(lines):
        for x in range(width):
            for c in range(ncomp):
                lut_val, lut_len = tables[c]
                code16 = reader.peek16()
                ssss = int(lut_val[code16])
                clen = int(lut_len[code16])
                if clen == 0:
                    raise LJpegError('Invalid Huffman code in scan data')
                reader.skip(clen)
                if ssss == 16:
                    diff = 32768
                else:
                    diff = _extend(reader.read(ssss), ssss)

                if y == 0 and x == 0:
                    pred = default_pred
                elif x == 0:
                    pred = out[y - 1, 0, c]          # first sample of a line: above
                elif y == 0:
                    pred = out[0, x - 1, c]          # first line: left
                else:
                    pred = _predict(out[y, x - 1, c], out[y - 1, x, c],
                                    out[y - 1, x - 1, c], predictor,
                                    point_transform, precision)
                out[y, x, c] = (pred + diff) & 0xFFFF
            mcu_count += 1
            if mcus_per_restart and mcu_count % mcus_per_restart == 0 \
                    and (y, x) != (lines - 1, width - 1):
                reader.resync()

    if point_transform:
        out <<= point_transform
    return out.astype(np.uint16), precision


# ----------------------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------------------

def _differences(samples, precision, predictor):
    """(lines, width, comps) differences of predictor 1, wrapped to
    [-32767, 32768], their SSSS categories and the optimal table's codes."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    lines, width, ncomp = samples.shape
    if ncomp > 4:
        raise LJpegError('At most 4 components per scan')
    if predictor != 1:
        raise LJpegError('The encoder implements predictor 1 (left)')

    x = samples.astype(np.int32)
    # difference image per component: left-neighbor prediction, first sample of
    # each line predicted from above, first sample overall from 2^(P-1)
    diffs = np.empty_like(x)
    diffs[:, 1:, :] = x[:, 1:, :] - x[:, :-1, :]
    diffs[1:, 0, :] = x[1:, 0, :] - x[:-1, 0, :]
    diffs[0, 0, :] = x[0, 0, :] - (1 << (precision - 1))
    # differences are defined modulo 2^16 (F.1.4.1); wrap to [-32767, 32768],
    # with 32768 encoded by the SSSS=16 escape (no magnitude bits)
    diffs = ((diffs + 0x8000) & 0xFFFF) - 0x8000
    diffs[diffs == -0x8000] = 0x8000

    mags = np.abs(diffs)
    ssss_all = np.where(
        mags > 0,
        np.floor(np.log2(np.maximum(mags, 1).astype(np.float64))).astype(np.int32) + 1,
        np.int32(0))

    vals, cnts = np.unique(ssss_all, return_counts=True)
    enc_bits, enc_values = _optimal_table(dict(zip(vals.tolist(), cnts.tolist())))
    return diffs, ssss_all, enc_bits, enc_values


def _stream(scan, lines, width, ncomp, precision, predictor, enc_bits, enc_values):
    """SOI, the DHT, SOF3 and SOS segments around an entropy-coded scan, EOI."""
    out = bytearray()
    out += struct.pack('>H', _SOI)
    # DHT (one table, class 0 id 0, shared by all components)
    dht = bytes([0x00]) + bytes(enc_bits) + bytes(enc_values)
    out += struct.pack('>HH', _DHT, 2 + len(dht)) + dht
    # SOF3
    sof = struct.pack('>BHHB', precision, lines, width, ncomp)
    for c in range(ncomp):
        sof += bytes([c + 1, 0x11, 0])
    out += struct.pack('>HH', _SOF3, 2 + len(sof)) + sof
    # SOS
    sos = bytes([ncomp])
    for c in range(ncomp):
        sos += bytes([c + 1, 0x00])
    sos += bytes([predictor, 0, 0])  # Ss=predictor, Se=0, Ah/Al=0
    out += struct.pack('>HH', _SOS, 2 + len(sos)) + sos
    out += scan
    out += struct.pack('>H', _EOI)
    return bytes(out)


def encode(samples, precision=16, predictor=1):
    """Encode (lines, width[, comps]) uint16 samples as an SOF3 stream
    (interleaved scan, predictor 1), the scan coded by the native codec."""
    diffs, _, enc_bits, enc_values = _differences(samples, precision, predictor)
    lines, width, ncomp = diffs.shape
    code_arr = np.zeros(17, np.uint32)
    len_arr = np.zeros(17, np.uint8)
    for sym, (code, clen) in _canonical_codes(enc_bits, enc_values).items():
        code_arr[sym] = code
        len_arr[sym] = clen
    flat = np.ascontiguousarray(diffs.reshape(-1), dtype=np.int32)
    cap = int(8 * flat.size + 64)
    out_buf = np.empty(cap, np.uint8)
    n_out = library().ljpeg_encode_scan(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), flat.size,
        code_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n_out < 0:
        raise LJpegError('native scan encoder overflow')
    return _stream(out_buf[:n_out].tobytes(), lines, width, ncomp, precision, predictor,
                   enc_bits, enc_values)


def encode_plain(samples, precision=16, predictor=1):
    """:func:`encode` with the scan coded by the Python loops (the plain
    version of the native codec)."""
    diffs, ssss_all, enc_bits, enc_values = _differences(samples, precision, predictor)
    lines, width, ncomp = diffs.shape
    codes = _canonical_codes(enc_bits, enc_values)
    writer = _BitWriter()
    for y in range(lines):
        for xx in range(width):
            for c in range(ncomp):
                diff = int(diffs[y, xx, c])
                ssss = int(ssss_all[y, xx, c])
                code, clen = codes[ssss]
                writer.write(code, clen)
                if ssss == 16:
                    continue
                if ssss:
                    bits = diff if diff >= 0 else diff + (1 << ssss) - 1
                    writer.write(bits, ssss)
    return _stream(writer.flush(), lines, width, ncomp, precision, predictor,
                   enc_bits, enc_values)
