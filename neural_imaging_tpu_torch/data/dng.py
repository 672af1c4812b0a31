"""
Pure-Python DNG (TIFF-EP) Bayer container support — read and write real camera
RAW files without libRAW/rawpy.
Copy of ``neural_imaging_tpu/data/dng.py``.

Scope: uncompressed CFA DNGs (Compression=1 — 8/16-bit words, or the MSB-first
bit-packed 12/14-bit rows real camera DNGs use) AND lossless-JPEG
compressed CFA DNGs (Compression=7, SOF3 via data/ljpeg.py — strips or tiles),
covering both variants ``dnglab``/``Adobe DNG Converter`` produce and cameras'
native DNG modes. No rawpy/libRAW anywhere.

The reader implements a real TIFF IFD walk (both byte orders, SubIFD chains) and
the standard DNG develop math: ``ColorMatrix1`` is XYZ(D65)->camera, so the
camera->sRGB matrix is recovered dcraw-style — compose with sRGB->XYZ, normalize
rows to preserve white, invert (ref helpers/raw.py:110-181 obtains the same
matrix from libRAW's ``color.rgb_cam``).

This gives the framework a first-class camera-file ingestion path that is exercised
hermetically in CI (tests write real-content DNGs and unpack them), replacing the
reference's hard dependency on rawkit/libRAW (readme.md:34).
"""
import struct

import numpy as np

# TIFF tag ids
_TAG_NEW_SUBFILE_TYPE = 254
_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_FILL_ORDER = 266
_TAG_MAKE = 271
_TAG_MODEL = 272
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_PLANAR_CONFIG = 284
_TAG_TILE_WIDTH = 322
_TAG_TILE_LENGTH = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_BYTE_COUNTS = 325
_TAG_SUB_IFDS = 330
_TAG_CFA_REPEAT_DIM = 33421
_TAG_CFA_PATTERN = 33422
_TAG_DNG_VERSION = 50706
_TAG_UNIQUE_CAMERA_MODEL = 50708
_TAG_BLACK_LEVEL = 50714
_TAG_WHITE_LEVEL = 50717
_TAG_COLOR_MATRIX_1 = 50721
_TAG_AS_SHOT_NEUTRAL = 50728
_TAG_CALIBRATION_ILLUMINANT_1 = 50778

_PHOTOMETRIC_CFA = 32803

# TIFF data types: id -> (struct code, size)
_TYPES = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8),
          6: ('b', 1), 7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 10: ('ii', 8),
          11: ('f', 4), 12: ('d', 8)}
_BYTE, _ASCII, _SHORT, _LONG, _RATIONAL, _UNDEFINED, _SRATIONAL = 1, 2, 3, 4, 5, 7, 10

_CFA_CODE = {0: 'R', 1: 'G', 2: 'B'}
_CFA_CODE_INV = {'R': 0, 'G': 1, 'B': 2}

# sRGB (D65) <-> CIE XYZ, IEC 61966-2-1
XYZ_TO_SRGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                        [-0.9692660, 1.8760108, 0.0415560],
                        [0.0556434, -0.2040259, 1.0572252]])
SRGB_TO_XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                        [0.2126729, 0.7151522, 0.0721750],
                        [0.0193339, 0.1191920, 0.9503041]])


class DNGError(ValueError):
    pass


# ----------------------------------------------------------------------------------
# Reading
# ----------------------------------------------------------------------------------

def _read_ifd(buf, offset, endian):
    """Parse one IFD: {tag: (type, values)} plus the next-IFD offset."""
    (n_entries,) = struct.unpack_from(endian + 'H', buf, offset)
    entries = {}
    pos = offset + 2
    for _ in range(n_entries):
        tag, typ, count = struct.unpack_from(endian + 'HHI', buf, pos)
        if typ not in _TYPES:
            pos += 12
            continue
        code, size = _TYPES[typ]
        total = size * count
        if total <= 4:
            data_off = pos + 8
        else:
            (data_off,) = struct.unpack_from(endian + 'I', buf, pos + 8)
        if typ == _ASCII:
            values = buf[data_off:data_off + count].split(b'\0')[0].decode('ascii', 'replace')
        elif typ in (_RATIONAL, _SRATIONAL):
            kind = 'I' if typ == _RATIONAL else 'i'
            raw = struct.unpack_from(endian + kind * (2 * count), buf, data_off)
            values = tuple(raw[2 * i] / (raw[2 * i + 1] or 1) for i in range(count))
        else:
            values = struct.unpack_from(endian + code * count, buf, data_off)
        entries[tag] = (typ, values)
        pos += 12
    (next_ifd,) = struct.unpack_from(endian + 'I', buf, pos)
    return entries, next_ifd


def _all_ifds(buf, endian, first_offset):
    """Walk the IFD chain plus any SubIFD trees, depth-first."""
    ifds = []
    stack = [first_offset]
    seen = set()
    while stack:
        off = stack.pop()
        if not off or off in seen or off >= len(buf):
            continue
        seen.add(off)
        entries, next_off = _read_ifd(buf, off, endian)
        ifds.append(entries)
        if next_off:
            stack.append(next_off)
        for sub in entries.get(_TAG_SUB_IFDS, (None, ()))[1]:
            stack.append(sub)
    return ifds


def _tag(ifd, tag, default=None):
    if tag in ifd:
        v = ifd[tag][1]
        return v
    return default


def _unpack_bitpacked(data, n_samples, bits):
    """Unpack an MSB-first bitstream of ``bits``-wide samples (packed CFA rows).

    Works on byte-aligned sample groups (lcm(bits, 8) bits: 3 bytes → two
    12-bit samples, 7 bytes → four 14-bit samples) assembled into one uint64
    per group — O(file size) transient memory, vs the ~1.5 GB an unpackbits
    matrix costs for a 24 MP 14-bit mosaic."""
    import math
    group_bits = bits * 8 // math.gcd(bits, 8)        # lcm(bits, 8)
    group_bytes = group_bits // 8
    group_samples = group_bits // bits
    n_groups = -(-n_samples // group_samples)
    need = n_groups * group_bytes
    arr = np.frombuffer(data, dtype=np.uint8, count=min(len(data), need))
    if len(arr) < need:                               # tolerate a short tail
        arr = np.concatenate([arr, np.zeros(need - len(arr), np.uint8)])
    grouped = arr.reshape(n_groups, group_bytes).astype(np.uint64)
    packed = np.zeros(n_groups, dtype=np.uint64)
    for i in range(group_bytes):                      # big-endian byte fold
        packed = (packed << np.uint64(8)) | grouped[:, i]
    mask = np.uint64((1 << bits) - 1)
    out = np.empty((n_groups, group_samples), dtype=np.uint16)
    for j in range(group_samples):
        shift = np.uint64(group_bits - (j + 1) * bits)
        out[:, j] = ((packed >> shift) & mask).astype(np.uint16)
    return out.reshape(-1)[:n_samples]


def _pack_bitpacked(values, bits):
    """Inverse of :func:`_unpack_bitpacked`: pack ``bits``-wide samples into an
    MSB-first bitstream, zero-padded to a byte boundary (fixture writer side)."""
    values = np.asarray(values, dtype=np.uint16).reshape(-1)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    bit_matrix = ((values[:, None].astype(np.uint32) >> shifts) & 1).astype(np.uint8)
    return np.packbits(bit_matrix.reshape(-1)).tobytes()


def read_dng(filename):
    """
    Parse a DNG file. Returns a dict with:

    - ``mosaic``: (H, W) uint16 CFA data
    - ``cfa_pattern``: e.g. 'RGGB'
    - ``black``, ``white``: sensor levels
    - ``cam_mul``: (4,) white-balance multipliers (R, G, B, G)
    - ``cam2srgb``: (3, 3) camera-RGB -> sRGB matrix (rows sum to 1)
    - ``camera``: camera model string
    """
    with open(filename, 'rb') as fh:
        buf = fh.read()
    if len(buf) < 8:
        raise DNGError('Truncated TIFF file')
    order = buf[:2]
    if order == b'II':
        endian = '<'
    elif order == b'MM':
        endian = '>'
    else:
        raise DNGError('Not a TIFF/DNG file (bad byte-order mark)')
    magic, first_ifd = struct.unpack_from(endian + 'HI', buf, 2)
    if magic != 42:
        raise DNGError('Not a TIFF/DNG file (bad magic)')

    ifds = _all_ifds(buf, endian, first_ifd)
    raw_ifd = None
    for ifd in ifds:
        if _tag(ifd, _TAG_PHOTOMETRIC, (0,))[0] == _PHOTOMETRIC_CFA:
            raw_ifd = ifd
            break
    if raw_ifd is None:
        raise DNGError('No CFA (raw) IFD found — not a Bayer DNG?')

    compression = _tag(raw_ifd, _TAG_COMPRESSION, (1,))[0]
    if compression not in (1, 7):
        raise DNGError(
            f'Compressed DNG (compression={compression}) is not supported; only '
            'uncompressed (1) and lossless JPEG (7) CFA data are handled.')

    width = _tag(raw_ifd, _TAG_WIDTH)[0]
    length = _tag(raw_ifd, _TAG_LENGTH)[0]
    bits = _tag(raw_ifd, _TAG_BITS, (16,))[0]
    if bits not in (8, 12, 14, 16):
        raise DNGError(f'Unsupported bit depth: {bits}')

    if compression == 7:
        mosaic = _read_lossless_jpeg_cfa(buf, raw_ifd, length, width)
    else:
        offsets = _tag(raw_ifd, _TAG_STRIP_OFFSETS)
        counts = _tag(raw_ifd, _TAG_STRIP_BYTE_COUNTS)
        if offsets is None or counts is None:
            raise DNGError('Missing strip offsets/byte counts')
        data = b''.join(buf[o:o + c] for o, c in zip(offsets, counts))
        if bits in (8, 16):
            dtype = np.dtype(('<' if endian == '<' else '>') + ('u2' if bits == 16 else 'u1'))
            if len(data) < width * length * dtype.itemsize:
                raise DNGError('Strip data is too short for the declared mosaic size')
            mosaic = np.frombuffer(data, dtype=dtype, count=width * length)
            mosaic = mosaic.reshape(length, width).astype(np.uint16)
        else:
            # 12/14-bit uncompressed CFA packs samples MSB-first (TIFF
            # FillOrder=1), each row starting on a byte boundary. FillOrder=2
            # (LSB-first) is legal TIFF but unseen in DNG practice — reject it
            # rather than decode plausible-looking garbage.
            fill_order = _tag(raw_ifd, _TAG_FILL_ORDER, (1,))[0]
            if fill_order != 1:
                raise DNGError(
                    f'FillOrder={fill_order} (LSB-first bit packing) is not '
                    'supported for 12/14-bit CFA strips')
            row_bytes = (width * bits + 7) // 8
            if len(data) < length * row_bytes:
                raise DNGError('Strip data is too short for the declared mosaic size')
            if (width * bits) % 8 == 0:
                mosaic = _unpack_bitpacked(data, width * length, bits)
                mosaic = mosaic.reshape(length, width)
            else:
                # Per-row byte padding: zero-pad every row to a whole sample
                # group so one vectorized unpack covers all rows at once
                # (a per-row loop costs thousands of small array ops on a
                # real-size mosaic).
                import math
                group_bytes = bits * 8 // math.gcd(bits, 8) // 8
                padded_bytes = -(-row_bytes // group_bytes) * group_bytes
                samples_per_row = padded_bytes * 8 // bits
                rows = np.frombuffer(data, np.uint8, count=length * row_bytes)
                padded = np.zeros((length, padded_bytes), np.uint8)
                padded[:, :row_bytes] = rows.reshape(length, row_bytes)
                mosaic = _unpack_bitpacked(padded.tobytes(),
                                           length * samples_per_row, bits)
                mosaic = mosaic.reshape(length, samples_per_row)[:, :width]

    dim = _tag(raw_ifd, _TAG_CFA_REPEAT_DIM, (2, 2))
    if tuple(dim) != (2, 2):
        raise DNGError(f'Only 2x2 CFA patterns are supported, got {dim}')
    pattern_codes = _tag(raw_ifd, _TAG_CFA_PATTERN, (0, 1, 1, 2))
    cfa_pattern = ''.join(_CFA_CODE.get(c, '?') for c in pattern_codes)

    # metadata may live on IFD0 rather than the raw SubIFD
    ifd0 = ifds[0]

    def meta(tag, default=None):
        v = _tag(raw_ifd, tag)
        if v is None:
            v = _tag(ifd0, tag, default)
        return v

    black_vals = meta(_TAG_BLACK_LEVEL, (0,))
    black = float(np.mean(black_vals))
    white = float(meta(_TAG_WHITE_LEVEL, ((1 << bits) - 1,))[0])

    neutral = meta(_TAG_AS_SHOT_NEUTRAL)
    if neutral is not None and len(neutral) == 3 and all(v > 0 for v in neutral):
        cam_mul = np.array([1.0 / neutral[0], 1.0 / neutral[1], 1.0 / neutral[2],
                            1.0 / neutral[1]], dtype=np.float32)
        cam_mul /= cam_mul[1]
    else:
        cam_mul = np.ones(4, dtype=np.float32)

    cm = meta(_TAG_COLOR_MATRIX_1)
    if cm is not None and len(cm) == 9:
        cam2srgb = color_matrix_to_cam2srgb(np.asarray(cm).reshape(3, 3))
    else:
        cam2srgb = np.eye(3)

    camera = meta(_TAG_UNIQUE_CAMERA_MODEL, meta(_TAG_MODEL, 'Unknown'))
    if isinstance(camera, tuple):
        camera = str(camera[0])

    return {'mosaic': mosaic, 'cfa_pattern': cfa_pattern, 'black': black,
            'white': white, 'cam_mul': cam_mul, 'cam2srgb': cam2srgb,
            'camera': camera}


def _unpack_ljpeg_segment(stream, th, tw):
    """Decode one lossless-JPEG segment into a (th, tw) uint16 tile.

    DNG packs CFA rows as multi-component scans (commonly 2 components holding
    the even/odd mosaic columns); any layout whose total sample count matches
    the tile is accepted: column-interleaved when dimensions line up exactly,
    row-major reflow otherwise (dcraw handles the same variants)."""
    from neural_imaging_tpu_torch.data import ljpeg
    dec, _ = ljpeg.decode(stream)
    lines, samples, ncomp = dec.shape
    if lines == th and samples * ncomp == tw:
        tile = np.empty((th, tw), dtype=np.uint16)
        for c in range(ncomp):
            tile[:, c::ncomp] = dec[:, :, c]
        return tile
    if lines * samples * ncomp == th * tw:
        return dec.reshape(-1)[:th * tw].reshape(th, tw).astype(np.uint16)
    raise DNGError(f'Lossless-JPEG segment geometry {dec.shape} does not match '
                   f'the {th}x{tw} tile')


def _read_lossless_jpeg_cfa(buf, raw_ifd, length, width):
    """Decode compression=7 CFA data from strips or tiles."""
    tile_offsets = _tag(raw_ifd, _TAG_TILE_OFFSETS)
    if tile_offsets is not None:
        counts = _tag(raw_ifd, _TAG_TILE_BYTE_COUNTS)
        tw = _tag(raw_ifd, _TAG_TILE_WIDTH)[0]
        th = _tag(raw_ifd, _TAG_TILE_LENGTH)[0]
        tiles_x = (width + tw - 1) // tw
        mosaic = np.zeros((length, width), dtype=np.uint16)
        for i, (off, cnt) in enumerate(zip(tile_offsets, counts)):
            ty, tx = divmod(i, tiles_x)
            tile = _unpack_ljpeg_segment(buf[off:off + cnt], th, tw)
            y0, x0 = ty * th, tx * tw
            h = min(th, length - y0)
            w = min(tw, width - x0)
            mosaic[y0:y0 + h, x0:x0 + w] = tile[:h, :w]
        return mosaic

    offsets = _tag(raw_ifd, _TAG_STRIP_OFFSETS)
    counts = _tag(raw_ifd, _TAG_STRIP_BYTE_COUNTS)
    if offsets is None or counts is None:
        raise DNGError('Missing strip/tile offsets for the compressed CFA data')
    rows_per_strip = _tag(raw_ifd, _TAG_ROWS_PER_STRIP, (length,))[0]
    mosaic = np.zeros((length, width), dtype=np.uint16)
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        y0 = i * rows_per_strip
        h = min(rows_per_strip, length - y0)
        mosaic[y0:y0 + h] = _unpack_ljpeg_segment(buf[off:off + cnt], h, width)
    return mosaic


def color_matrix_to_cam2srgb(color_matrix_1):
    """DNG ColorMatrix1 (XYZ(D65)->cam) -> normalized cam->sRGB (dcraw method):
    srgb2cam = CM @ (sRGB->XYZ), rows scaled to sum 1 (white preservation), then
    inverted."""
    srgb2cam = np.asarray(color_matrix_1, dtype=np.float64) @ SRGB_TO_XYZ
    rows = srgb2cam.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    srgb2cam = srgb2cam / rows
    return np.linalg.inv(srgb2cam)


def cam2srgb_to_color_matrix(cam2srgb):
    """Inverse of :func:`color_matrix_to_cam2srgb` (up to row normalization)."""
    srgb2cam = np.linalg.inv(np.asarray(cam2srgb, dtype=np.float64))
    srgb2cam = srgb2cam / srgb2cam.sum(axis=1, keepdims=True)
    return srgb2cam @ XYZ_TO_SRGB


# ----------------------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------------------

def _pack_values(typ, values, endian):
    code, size = _TYPES[typ]
    if typ == _ASCII:
        data = values.encode('ascii') + b'\0'
        return data, len(data)
    if typ in (_RATIONAL, _SRATIONAL):
        kind = 'I' if typ == _RATIONAL else 'i'
        flat = []
        for v in values:
            num, den = _to_rational(v, signed=(typ == _SRATIONAL))
            flat += [num, den]
        return struct.pack(endian + kind * len(flat), *flat), len(values) * 8
    data = struct.pack(endian + code * len(values), *values)
    return data, len(data)


def _to_rational(v, signed=False, den=10000):
    return int(round(v * den)), den


def write_dng(filename, mosaic_u16, cfa_pattern='RGGB', black=0, white=None,
              cam_mul=(1.0, 1.0, 1.0, 1.0), cam2srgb=None, camera='neural-imaging-tpu',
              compression='none', bits=16):
    """Write a Bayer DNG (single IFD, single strip).

    ``compression``: 'none' (tag 1, raw samples — little-endian uint16 at
    ``bits=16``, MSB-first bit-packed rows at 12/14 bit like real camera DNGs)
    or 'ljpeg' (tag 7, lossless JPEG / SOF3 — the standard compressed-DNG
    encoding, with the mosaic's even/odd columns as the scan's two components)."""
    mosaic = np.ascontiguousarray(np.asarray(mosaic_u16, dtype=np.uint16))
    if mosaic.ndim != 2:
        raise DNGError('mosaic must be 2-D (H, W)')
    if compression not in ('none', 'ljpeg'):
        raise DNGError(f'Unsupported compression {compression!r}')
    if bits not in (12, 14, 16):
        raise DNGError(f'Unsupported bit depth {bits} (expected 12, 14 or 16)')
    if bits < 16 and int(mosaic.max(initial=0)) >= (1 << bits):
        raise DNGError(f'mosaic values exceed the declared {bits}-bit range')
    h, w = mosaic.shape
    if white is None:
        white = (1 << bits) - 1
    if cam2srgb is None:
        cam2srgb = np.eye(3)
    cm1 = cam2srgb_to_color_matrix(cam2srgb).reshape(-1)
    cam_mul = np.asarray(cam_mul, dtype=np.float64)
    g = cam_mul[1] if cam_mul[1] else 1.0
    neutral = (g / max(cam_mul[0], 1e-9), 1.0, g / max(cam_mul[2], 1e-9))
    pattern_codes = tuple(_CFA_CODE_INV[c] for c in cfa_pattern.upper())

    endian = '<'
    if compression == 'ljpeg':
        from neural_imaging_tpu_torch.data import ljpeg
        if w % 2:
            raise DNGError('ljpeg DNG writing needs an even mosaic width')
        comps = np.stack([mosaic[:, 0::2], mosaic[:, 1::2]], axis=-1)
        pixel_data = ljpeg.encode(comps, precision=bits)
    elif bits == 16:
        pixel_data = mosaic.astype('<u2').tobytes()
    elif (w * bits) % 8 == 0:                  # rows already byte-aligned
        pixel_data = _pack_bitpacked(mosaic, bits)
    else:                                      # pad every row to a byte boundary
        pixel_data = b''.join(_pack_bitpacked(mosaic[r], bits) for r in range(h))

    entries = [
        (_TAG_NEW_SUBFILE_TYPE, _LONG, (0,)),
        (_TAG_WIDTH, _LONG, (w,)),
        (_TAG_LENGTH, _LONG, (h,)),
        (_TAG_BITS, _SHORT, (bits,)),
        (_TAG_COMPRESSION, _SHORT, (7 if compression == 'ljpeg' else 1,)),
        (_TAG_PHOTOMETRIC, _SHORT, (_PHOTOMETRIC_CFA,)),
        (_TAG_MAKE, _ASCII, 'neural-imaging-tpu'),
        (_TAG_MODEL, _ASCII, camera),
        (_TAG_STRIP_OFFSETS, _LONG, None),  # patched below
        (_TAG_SAMPLES_PER_PIXEL, _SHORT, (1,)),
        (_TAG_ROWS_PER_STRIP, _LONG, (h,)),
        (_TAG_STRIP_BYTE_COUNTS, _LONG, (len(pixel_data),)),
        (_TAG_PLANAR_CONFIG, _SHORT, (1,)),
        (_TAG_CFA_REPEAT_DIM, _SHORT, (2, 2)),
        (_TAG_CFA_PATTERN, _BYTE, pattern_codes),
        (_TAG_DNG_VERSION, _BYTE, (1, 4, 0, 0)),
        (_TAG_UNIQUE_CAMERA_MODEL, _ASCII, camera),
        (_TAG_BLACK_LEVEL, _SHORT, (int(black),)),
        (_TAG_WHITE_LEVEL, _SHORT if white < 65536 else _LONG, (int(white),)),
        (_TAG_COLOR_MATRIX_1, _SRATIONAL, tuple(cm1)),
        (_TAG_AS_SHOT_NEUTRAL, _RATIONAL, neutral),
        (_TAG_CALIBRATION_ILLUMINANT_1, _SHORT, (21,)),  # D65
    ]
    entries.sort(key=lambda e: e[0])

    header_size = 8
    ifd_size = 2 + 12 * len(entries) + 4
    overflow_start = header_size + ifd_size
    overflow = b''
    packed = []
    # first pass to size the overflow area, second to emit with the pixel offset
    pixel_offset = None

    def build(pixel_offset_value):
        nonlocal overflow
        overflow = b''
        packed.clear()
        for tag, typ, values in entries:
            if tag == _TAG_STRIP_OFFSETS:
                values = (pixel_offset_value,)
            data, logical = _pack_values(typ, values, endian)
            count = (len(values) if typ != _ASCII else len(data))
            if len(data) <= 4:
                inline = data + b'\0' * (4 - len(data))
                packed.append(struct.pack(endian + 'HHI', tag, typ, count) + inline)
            else:
                off = overflow_start + len(overflow)
                packed.append(struct.pack(endian + 'HHII', tag, typ, count, off))
                overflow += data
                if len(overflow) % 2:
                    overflow += b'\0'

    build(0)
    pixel_offset = overflow_start + len(overflow)
    build(pixel_offset)

    with open(filename, 'wb') as fh:
        fh.write(b'II' + struct.pack('<HI', 42, header_size))
        fh.write(struct.pack('<H', len(entries)))
        fh.write(b''.join(packed))
        fh.write(struct.pack('<I', 0))  # no next IFD
        fh.write(overflow)
        fh.write(pixel_data)
    return filename
