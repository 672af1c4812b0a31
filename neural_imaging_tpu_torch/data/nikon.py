"""
Nikon type-34713 NEF entropy coding (lossless AND lossy variants). Copy of
``neural_imaging_tpu/data/nikon.py``; the decoder runs the native scan codec
(``ljpeg.library()``, no fallback), the Python loop stays as its plain
version (:func:`decode_plain`), and :func:`encode_lossy` codes the rows
before the tree split, whose coding is exact, with whole-array operations.

The reference reads compressed NEFs through libRAW (ref helpers/raw.py:110-181);
this module implements the coding natively. The bitstream format is publicly
documented (dcraw's ``nikon_load_raw``, the canonical open description of
Compression=34713): a raw MSB-first Huffman bitstream (no JPEG byte stuffing or
markers) of per-sample differences with

- fixed per-(bit-depth, variant) Huffman trees whose symbols pack
  ``(shl << 4) | len`` (``shl`` is 0 in the lossless trees — the symbol is then
  exactly a JPEG SSSS category; the lossy after-split trees use ``shl > 0``
  symbols that requantize mid-size differences, which is where the loss is),
- the first two columns of each row predicted vertically from the same-parity
  row two above (``vpred``, seeded from the metadata block), all other columns
  predicted from the same-CFA-column sample two to the left (``hpred``), and
- a final linearization curve (identity for the lossless variant; stored
  verbatim in the type-1 lossy layout, sampled on a uniform grid + linearly
  interpolated in the type-2 layout, which also carries the row where the
  decoder switches to the after-split tree).

The compression metadata lives in MakerNote tag 0x0096: version bytes, the
four ``vpred`` seeds and the curve block. Both variants are implemented end to
end — encoders (for hermetic round-trip fixtures; the lossy one runs the
decoder's reconstruction closed-loop) + decoder with a native C++ scan core
(``native/ljpeg/ljpeg.cpp: nikon_decode_scan``).
"""
import ctypes
import struct

import numpy as np

from neural_imaging_tpu_torch.data import ljpeg


class NikonFormatError(ValueError):
    pass


# Fixed Huffman trees of the NEF coding: (BITS[1..16], HUFFVAL), keyed by
# (variant, bit depth). These are published format constants (identical in
# every open decoder). Lossless symbols are plain SSSS categories (shl nibble
# = 0); the lossy after-split trees drop the mid categories and replace them
# with shifted symbols ``(shl << 4) | len`` that quantize large differences —
# that quantization is what makes the variant lossy. All six BITS rows are
# Kraft-complete (verified by tests).
TREES = {
    ('lossy', 12): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
                    (5, 4, 3, 6, 2, 7, 1, 0, 8, 9, 11, 10, 12, 0)),
    ('lossy_split', 12): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
                          (0x39, 0x5A, 0x38, 0x27, 0x16, 5, 4, 3, 2, 1, 0,
                           11, 12, 12)),
    ('lossless', 12): ((0, 1, 4, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
                       (5, 4, 6, 3, 7, 2, 8, 1, 9, 0, 10, 11, 12)),
    ('lossy', 14): ((0, 1, 4, 3, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0, 0),
                    (5, 6, 4, 7, 8, 3, 9, 2, 1, 0, 10, 11, 12, 13, 14)),
    ('lossy_split', 14): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 2, 0, 0, 0, 0, 0),
                          (8, 0x5C, 0x4B, 0x3A, 0x29, 7, 6, 5, 4, 3, 2, 1, 0,
                           13, 14)),
    ('lossless', 14): ((0, 1, 4, 2, 2, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0),
                       (7, 6, 8, 5, 9, 4, 10, 3, 11, 12, 2, 0, 1, 13, 14)),
}
LOSSLESS_TREES = {b: TREES[('lossless', b)] for b in (12, 14)}

_VER_LOSSLESS = 0x46
_SPLIT_OFFSET = 562   # blob offset of the split row (0x44/0x20 layout)


def parse_meta(blob, endian='<', bits=None):
    """Parse a MakerNote tag 0x0096 block →
    dict(ver0, ver1, vpred, curve_size, curve, split, variant).

    Layouts (the documented 34713 metadata block): version bytes, the four
    vpred seeds, a curve-size short, then

    - **lossless** (ver0 0x46): no curve (identity linearization);
    - **lossy type 2** (ver0 0x44, ver1 0x20 — split-capable bodies):
      ``csize`` curve samples on a uniform grid of step ``(1 << bits) //
      (csize - 1)``, linearly interpolated to the full input range, plus the
      tree-split row stored at blob offset 562;
    - **lossy type 1** (any other version): the full curve of ``csize``
      entries stored verbatim.

    ``bits`` is required to interpolate the type-2 curve grid."""
    if len(blob) < 12:
        raise NikonFormatError('Nikon compression metadata block is truncated')
    ver0, ver1 = blob[0], blob[1]
    pos = 2
    if ver0 == 0x49 or ver1 == 0x58:
        pos += 2110  # documented skip for these versions' padding block
    if len(blob) < pos + 10:
        raise NikonFormatError('Nikon compression metadata block is truncated')
    vpred = np.array(struct.unpack_from(endian + '4H', blob, pos), dtype=np.int32)
    pos += 8
    (csize,) = struct.unpack_from(endian + 'H', blob, pos)
    pos += 2
    meta = {'ver0': ver0, 'ver1': ver1, 'vpred': vpred, 'curve_size': csize,
            'curve': None, 'split': 0, 'variant': 'lossless'}
    if ver0 == _VER_LOSSLESS:
        return meta
    meta['variant'] = 'lossy'

    def read_shorts(n):
        if len(blob) < pos + 2 * n:
            raise NikonFormatError('Nikon curve block is truncated')
        return np.frombuffer(blob, dtype=np.dtype(endian + 'u2'),
                             count=n, offset=pos)

    step = 0
    if ver0 == 0x44 and ver1 == 0x20 and csize > 1:
        if bits is None:
            raise NikonFormatError('bit depth required for the type-2 curve')
        vmax = (1 << bits) & 0x7FFF
        step = vmax // (csize - 1)
    if step > 0:
        # type 2: samples on a uniform grid, linearly interpolated; the tail
        # beyond the sampled span stays identity, as open decoders pre-fill
        samples = read_shorts(csize).astype(np.uint32)
        curve = np.arange(vmax + step, dtype=np.uint32)
        curve[np.arange(csize) * step] = samples
        i = np.arange(vmax)
        frac = i % step
        base = i - frac
        curve[:vmax] = (curve[base] * (step - frac)
                        + curve[base + step] * frac) // step
        meta['curve'] = curve[:vmax].astype(np.uint16)
        if len(blob) >= _SPLIT_OFFSET + 2:
            (meta['split'],) = struct.unpack_from(endian + 'H', blob,
                                                  _SPLIT_OFFSET)
    elif 1 < csize <= 0x4001:
        # type 1: the full curve stored verbatim
        meta['curve'] = read_shorts(csize).astype(np.uint16)
    return meta


def build_meta(mosaic, endian='<'):
    """Metadata block for :func:`encode`: lossless version bytes + vpred seeds
    (the first two samples of rows 0 and 1, so their coded diffs are zero)."""
    m = np.asarray(mosaic)
    vpred = [int(m[0, 0]), int(m[0, 1]),
             int(m[1, 0]) if m.shape[0] > 1 else 0,
             int(m[1, 1]) if m.shape[0] > 1 else 0]
    return (bytes((_VER_LOSSLESS, 0x30))
            + struct.pack(endian + '4H', *vpred)
            + struct.pack(endian + 'H', 1))  # csize 1: no curve (identity)


def build_meta_lossy(vpred, curve_samples=None, split=0, full_curve=None,
                     endian='<'):
    """Metadata block for a lossy fixture.

    ``curve_samples`` → the type-2 layout (ver 0x44/0x20): grid samples +
    split row at offset 562. ``full_curve`` → the type-1 layout (ver
    0x42/0x10): the curve stored verbatim. Neither → lossy with identity
    linearization (csize 1)."""
    head = struct.pack(endian + '4H', *[int(v) for v in vpred])
    if curve_samples is not None:
        samples = np.asarray(curve_samples, np.uint16)
        body = (head + struct.pack(endian + 'H', len(samples))
                + samples.astype(np.dtype(endian + 'u2')).tobytes())
        blob = bytes((0x44, 0x20)) + body
        blob += b'\0' * max(0, _SPLIT_OFFSET - len(blob))
        return blob + struct.pack(endian + 'H', int(split))
    if full_curve is not None:
        curve = np.asarray(full_curve, np.uint16)
        return (bytes((0x42, 0x10)) + head
                + struct.pack(endian + 'H', len(curve))
                + curve.astype(np.dtype(endian + 'u2')).tobytes())
    return bytes((0x42, 0x10)) + head + struct.pack(endian + 'H', 1)


# ----------------------------------------------------------------------------------
# Encoder (fixture synthesis; pure numpy)
# ----------------------------------------------------------------------------------

def _pack_bits(values, lengths):
    """MSB-first concatenation of (value, bit-length ≤ 32) pairs → bytes,
    zero-padded to a whole byte: each value's low ``length`` bits, aligned at
    its bit offset, span at most 5 bytes; the bytes of different values
    share no bit, so summing them (``np.bincount``) ORs them."""
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.size and int(lengths.max()) > 32:
        raise NikonFormatError('bit fields longer than 32 bits')
    total = int(lengths.sum())
    n_bytes = -(-total // 8)
    pos = np.cumsum(lengths) - lengths
    v = np.asarray(values, dtype=np.uint64) & ((np.uint64(1) << lengths.astype(np.uint64))
                                               - np.uint64(1))
    # the value's first bit at bit 63 - pos % 8 of a 64-bit window at byte pos // 8
    aligned = np.where(lengths > 0, v << (np.uint64(64) - lengths.astype(np.uint64)),
                       np.uint64(0)) >> (pos % 8).astype(np.uint64)
    first = pos // 8
    out = np.zeros(n_bytes + 5, dtype=np.float64)
    for k in range(5):
        byte = (aligned >> np.uint64(56 - 8 * k)) & np.uint64(0xFF)
        out += np.bincount(first + k, weights=byte.astype(np.float64), minlength=n_bytes + 5)
    return out[:n_bytes].astype(np.uint8).tobytes()


def _exact_fields(m, code_lut, len_lut):
    """(bit field, bit length) of each sample of a mosaic whose differences
    are coded exactly: its code, then its JPEG-style magnitude bits; the first two
    columns predicted from the same-parity row two above (rows 0 and 1
    absorbed into the vpred seeds), the others from two columns left."""
    h, w = m.shape
    diffs = np.empty((h, w), dtype=np.int32)
    diffs[:, 2:] = m[:, 2:] - m[:, :-2]           # horizontal, same CFA column
    diffs[2:, :2] = m[2:, :2] - m[:-2, :2]        # vertical seeds, same parity row
    diffs[:2, :2] = 0                             # absorbed into the vpred seeds

    flat = diffs.reshape(-1)
    mag = np.abs(flat)
    ssss = np.zeros(flat.shape, dtype=np.int32)
    nz = mag > 0
    ssss[nz] = np.floor(np.log2(mag[nz])).astype(np.int32) + 1

    # JPEG-style magnitude bits: d >= 0 → d, d < 0 → d + 2^ssss - 1
    magbits = np.where(flat >= 0, flat, flat + (1 << ssss) - 1).astype(np.uint64)
    # one bit field a sample: its code followed by its magnitude bits
    fields = (code_lut[ssss].astype(np.uint64) << ssss.astype(np.uint64)) | magbits
    return fields, len_lut[ssss] + ssss


def encode(mosaic, bits):
    """Encode a uint16 mosaic as a lossless type-34713 bitstream.

    Returns (payload bytes, metadata blob for MakerNote tag 0x0096)."""
    if bits not in LOSSLESS_TREES:
        raise NikonFormatError(f'No lossless Nikon tree for {bits}-bit data')
    m = np.asarray(mosaic, dtype=np.int32)
    if m.ndim != 2 or m.shape[0] < 1 or m.shape[1] < 2:
        raise NikonFormatError('Mosaic must be 2D with width >= 2')
    if m.max(initial=0) >= (1 << bits):
        raise NikonFormatError(f'Mosaic exceeds the {bits}-bit range')
    h, w = m.shape

    tree_bits, tree_vals = LOSSLESS_TREES[bits]
    codes = ljpeg._canonical_codes(list(tree_bits), list(tree_vals))
    code_lut = np.zeros(17, dtype=np.uint32)
    len_lut = np.zeros(17, dtype=np.int64)
    for sym, (code, length) in codes.items():
        code_lut[sym], len_lut[sym] = code, length
    fields, lengths = _exact_fields(m, code_lut, len_lut)
    return _pack_bits(fields, lengths), build_meta(m)


def _symbol_table(tree_bits, tree_vals):
    """Per-category encoding choice: {len: (shl, code, codelen)} — plain
    (shl=0) symbols preferred, else the least-shifted symbol of that length."""
    codes = ljpeg._canonical_codes(list(tree_bits), list(tree_vals))
    best = {}
    for sym, (code, codelen) in codes.items():
        slen, shl = sym & 15, sym >> 4
        if slen not in best or shl < best[slen][0]:
            best[slen] = (shl, code, codelen)
    return best


def encode_lossy(indices, bits, split=0):
    """Encode curve-domain indices as a lossy type-34713 bitstream.

    Pre-split rows use the plain-category lossy tree (every SSSS category is
    present → exact); rows from ``split`` on use the after-split tree, whose
    shifted symbols ``(shl << 4) | len`` quantize mid-size differences by up
    to ``2**shl``. The encoder runs the decoder's reconstruction closed-loop
    (standard DPCM), so the stream decodes to the returned reconstruction
    exactly. Returns (payload, reconstructed, vpred_seeds)."""
    m = np.asarray(indices, dtype=np.int32)
    if m.ndim != 2 or m.shape[0] < 2 or m.shape[1] < 2:
        raise NikonFormatError('Mosaic must be 2D with height/width >= 2')
    h, w = m.shape
    table = _symbol_table(*TREES[('lossy', bits)])
    table_split = _symbol_table(*TREES[('lossy_split', bits)])

    vals, lens = [], []

    def emit(value, length):
        vals.append(value)
        lens.append(length)

    def code_diff(d, tab):
        """Encode one difference; return the decoder's reconstruction."""
        if d == 0:
            shl, code, codelen = tab[0]
            emit(code, codelen)
            return 0
        c = int(abs(d)).bit_length()
        shl, code, codelen = tab[c]
        emit(code, codelen)
        if shl == 0:
            v = d if d > 0 else d + (1 << c) - 1
            emit(v & ((1 << c) - 1), c)
            return d
        if d > 0:
            v = d >> shl
        else:
            v = min((d + (1 << c)) >> shl, (1 << (c - 1 - shl)) - 1)
        emit(v, c - shl)
        raw = (((v << 1) + 1) << shl) >> 1
        return raw if raw & (1 << (c - 1)) else raw - (1 << c)

    vpred_seed = [int(m[0, 0]), int(m[0, 1]), int(m[1, 0]), int(m[1, 1])]
    recon = np.empty((h, w), dtype=np.int32)
    # Rows before the split use the tree with every plain SSSS category, so
    # they are coded exactly: the reconstruction is the input, and the
    # differences are the lossless coder's (each category's code is the one
    # the loop below would choose).
    exact = min(split, h) if split else h
    if exact < 2:
        exact = 0
    first = 0
    exact_v, exact_l = np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if exact:
        if max(shl for shl, _, _ in table.values()):
            raise NikonFormatError('the pre-split lossy tree has shifted symbols')
        code_lut = np.zeros(17, dtype=np.uint32)
        len_lut = np.zeros(17, dtype=np.int64)
        for c, (_, code, codelen) in table.items():
            code_lut[c], len_lut[c] = code, codelen
        if not set(range(bits + 1)) <= table.keys():
            raise NikonFormatError(f'the lossy {bits}-bit tree lacks a category')
        exact_v, exact_l = _exact_fields(m[:exact], code_lut, len_lut)
        recon[:exact] = m[:exact]
        first = exact
    vpred = [[int(v) for v in recon[first - 2, :2]], [int(v) for v in recon[first - 1, :2]]] \
        if first else [vpred_seed[:2], vpred_seed[2:]]
    if first % 2:
        vpred = vpred[::-1]
    for row in range(first, h):
        tab = table_split if split and row >= split else table
        hpred = [0, 0]
        for col in range(w):
            target = int(m[row, col])
            pred = vpred[row & 1][col] if col < 2 else hpred[col & 1]
            d = code_diff(target - pred, tab)
            if col < 2:
                vpred[row & 1][col] += d
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] += d
            recon[row, col] = hpred[col & 1]
    payload = _pack_bits(np.concatenate([exact_v, np.asarray(vals, np.uint64)]),
                         np.concatenate([exact_l, np.asarray(lens, np.int64)]))
    return payload, recon, vpred_seed


# ----------------------------------------------------------------------------------
# Decoder — native C++ core; the Python loop is its plain version
# ----------------------------------------------------------------------------------

def _decode_plain(data, lines, width, bits, vpred_init,
                   variant='lossless', split=0, curve=None):
    tree_bits, tree_vals = TREES[(variant, bits)]
    lut_val, lut_len = ljpeg._decode_table(list(tree_bits), list(tree_vals))
    if curve is None:
        clamp = (1 << bits) - 1
    else:
        curve = np.asarray(curve, np.uint16)
        clamp = len(curve) - 1

    # raw bitstream (no 0xFF stuffing): simple accumulator reader
    arr = np.frombuffer(data, dtype=np.uint8)
    acc, nbits, pos = 0, 0, 0

    out = np.empty((lines, width), dtype=np.uint16)
    vpred = [[int(vpred_init[0]), int(vpred_init[1])],
             [int(vpred_init[2]), int(vpred_init[3])]]
    for row in range(lines):
        if split and row == split:
            tree_bits, tree_vals = TREES[(variant + '_split', bits)]
            lut_val, lut_len = ljpeg._decode_table(list(tree_bits),
                                                   list(tree_vals))
        hpred = [0, 0]
        for col in range(width):
            while nbits < 32:
                byte = int(arr[pos]) if pos < len(arr) else 0
                acc = ((acc << 8) | byte) & 0xFFFFFFFFFFFF
                nbits += 8
                pos += 1
            look = (acc >> (nbits - 16)) & 0xFFFF
            clen = int(lut_len[look])
            if clen == 0:
                raise NikonFormatError('Invalid Huffman code in NEF bitstream')
            sym = int(lut_val[look])
            nbits -= clen
            slen = sym & 15
            shl = sym >> 4
            if slen:
                v = (acc >> (nbits - (slen - shl))) & ((1 << (slen - shl)) - 1)
                nbits -= slen - shl
                # shifted reconstruction: mid-rise requantization of the
                # dropped shl low bits, then the usual SSSS sign extension
                diff = (((v << 1) + 1) << shl) >> 1
                if (diff & (1 << (slen - 1))) == 0:
                    diff -= (1 << slen) - (0 if shl else 1)
            else:
                diff = 0
            if col < 2:
                vpred[row & 1][col] += diff
                hpred[col] = vpred[row & 1][col]
            else:
                hpred[col & 1] += diff
            v = min(max(hpred[col & 1], 0), clamp)
            out[row, col] = v if curve is None else curve[v]
    return out


def _decode_native(data, lines, width, bits, vpred_init,
                   variant='lossless', split=0, curve=None):
    lib = ljpeg.library()
    tree_bits, tree_vals = TREES[(variant, bits)]
    bits_arr = np.asarray(tree_bits, dtype=np.uint8)
    vals_arr = np.asarray(tree_vals, dtype=np.uint8)
    sp_key = (variant + '_split', bits)
    sp_bits, sp_vals = TREES[sp_key] if split and sp_key in TREES \
        else (tree_bits, tree_vals)
    sp_bits_arr = np.asarray(sp_bits, dtype=np.uint8)
    sp_vals_arr = np.asarray(sp_vals, dtype=np.uint8)
    vpred = np.asarray(vpred_init, dtype=np.int32)
    if curve is None:
        curve = np.arange(1 << bits, dtype=np.uint16)  # identity curve
    else:
        curve = np.ascontiguousarray(curve, dtype=np.uint16)
    out = np.empty((lines, width), dtype=np.uint16)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.nikon_decode_scan(
        data, len(data),
        bits_arr.ctypes.data_as(u8p), vals_arr.ctypes.data_as(u8p), len(vals_arr),
        sp_bits_arr.ctypes.data_as(u8p), sp_vals_arr.ctypes.data_as(u8p),
        len(sp_vals_arr),
        lines, width, int(split),
        vpred.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        curve.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), len(curve),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise NikonFormatError(f'Malformed Nikon NEF bitstream (native rc={rc})')
    return out


def decode(data, lines, width, bits, meta_blob, endian='<'):
    """Decode a type-34713 bitstream → (lines, width) uint16 mosaic.

    ``meta_blob`` is the raw MakerNote tag 0x0096 payload; its version bytes
    select the variant — lossless (0x46), lossy type 2 (0x44/0x20:
    interpolated curve + tree split) or lossy type 1 (verbatim curve)."""
    if bits not in (12, 14):
        raise NikonFormatError(f'No Nikon trees for {bits}-bit data')
    meta = parse_meta(meta_blob, endian, bits=bits)
    args = (bytes(data), lines, width, bits, meta['vpred'])
    kw = {'variant': meta['variant'], 'split': meta['split'],
          'curve': meta['curve']}
    return _decode_native(*args, **kw)


def decode_plain(data, lines, width, bits, meta_blob, endian='<'):
    """:func:`decode` with the Python loop (the native decoder's plain version)."""
    if bits not in (12, 14):
        raise NikonFormatError(f'No Nikon trees for {bits}-bit data')
    meta = parse_meta(meta_blob, endian, bits=bits)
    return _decode_plain(bytes(data), lines, width, bits, meta['vpred'],
                         variant=meta['variant'], split=meta['split'], curve=meta['curve'])
