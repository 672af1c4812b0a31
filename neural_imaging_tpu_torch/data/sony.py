"""
Sony cRAW / ARW2 (Compression=32767) entropy coding and SR2 metadata crypto.
Copy of ``neural_imaging_tpu/data/sony.py``.

The reference reads compressed ARWs through libRAW (ref helpers/raw.py:110-181);
this module implements the coding natively. The bitstream format is publicly
documented (dcraw's ``sony_arw2_load_raw`` is the canonical open description of
Compression=32767): every row of a ``width``-pixel mosaic occupies exactly
``width`` bytes, split into 16-byte / 128-bit little-endian blocks. Each block
codes **16 same-CFA-color pixels** (columns of one parity within a 32-column
group; each group stores its even-column block first, then its odd-column
block):

- bits 0-10: ``max`` (11-bit), bits 11-21: ``min``,
- bits 22-25: index of the max pixel, bits 26-29: index of the min pixel,
- bits 30-127: fourteen 7-bit deltas for the remaining pixels, scaled as
  ``pix = min + (delta << sh)`` where ``sh`` is the smallest shift in [0, 4]
  with ``0x80 << sh > max - min`` (capped at 4).

The decoded 11-bit codes pass through Sony's segmented tone curve — five
linear segments with step sizes 1, 2, 4, 8, 16 whose breakpoints come from
private tag 0x7010 — mapping them back to linear sensor values. The private
metadata IFD (curve 0x7010, per-channel black 0x7310, as-shot WB 0x7313) is
stored XOR-encrypted; tags 0x7200/0x7201/0x7221 give its offset, length and
key, and :func:`decrypt` implements the public lagged-Fibonacci keystream
(dcraw's ``sony_decrypt``).

Both directions are implemented — a vectorized numpy decoder and an encoder
used by the hermetic round-trip fixtures (``camera_raw.write_arw(...,
compression='sony-craw')``). Coding is lossy by design (the 7-bit deltas
quantize by ``2**sh - 1`` at most, and the curve's wide segments quantize by
up to 16); the tests bound both error terms exactly.
"""
import numpy as np


class SonyFormatError(ValueError):
    pass


CODE_MAX = _CODE_MAX = 0x7FF      # 11-bit coded domain
_CURVE_STEPS = (1, 2, 4, 8, 16)   # per-segment step sizes of the tone curve


# ----------------------------------------------------------------------------------
# Tone curve (private tag 0x7010)
# ----------------------------------------------------------------------------------

def build_curve(posts):
    """Expand the four tag-0x7010 breakpoints into the 4096-entry tone curve.

    ``posts`` are the raw SHORT values; each is ``>> 2 & 0xfff`` to a 12-bit
    breakpoint. Segment ``i`` of ``[0, p0], (p0, p1], ... (p3, 4095]`` grows by
    ``2**i`` per input step. Decoded 11-bit codes index the curve as
    ``curve[code << 1] >> 2`` (the coded domain is the curve's even entries).
    """
    pts = [0] + [(int(p) >> 2) & 0xFFF for p in posts] + [0xFFF]
    if any(b < a for a, b in zip(pts, pts[1:])):
        raise SonyFormatError(f'Non-monotone Sony curve breakpoints: {posts}')
    curve = np.arange(0x1000, dtype=np.uint32)
    for i, step in enumerate(_CURVE_STEPS):
        lo, hi = pts[i], pts[i + 1]
        if hi > lo:
            curve[lo + 1:] = curve[lo] + step * np.arange(1, 0x1000 - lo,
                                                          dtype=np.uint32)
    return curve


def curve_white(curve):
    """Linear-domain white level: the curve image of the max 11-bit code."""
    return int(curve[_CODE_MAX << 1] >> 2)


def _codes_to_values(codes, curve):
    return (curve[codes.astype(np.int32) << 1] >> 2).astype(np.uint16)


def _values_to_codes(values, curve):
    """Inverse tone mapping: nearest 11-bit code for each linear value."""
    table = (curve[(np.arange(_CODE_MAX + 1) << 1)] >> 2).astype(np.int32)
    codes = np.searchsorted(table, np.asarray(values, np.int32), side='left')
    codes = np.clip(codes, 0, _CODE_MAX)
    # searchsorted gives the first code with table >= value; the previous code
    # can be closer for wide segments
    prev = np.clip(codes - 1, 0, _CODE_MAX)
    use_prev = (np.abs(table[prev] - values) <= np.abs(table[codes] - values))
    return np.where(use_prev, prev, codes).astype(np.uint16)


# ----------------------------------------------------------------------------------
# Block codec
# ----------------------------------------------------------------------------------

def decode(data, height, width, curve=None):
    """Decode a cRAW pixel stream → uint16 mosaic (height, width).

    ``data`` holds ``height * width`` bytes (one byte per pixel on average).
    With ``curve`` the output is in the linear sensor domain; without it the
    raw 11-bit codes are returned. Columns beyond the last full 32-column
    group are zero (they are not coded — same behavior as open decoders).
    """
    need = height * width
    if len(data) < need:
        raise SonyFormatError(
            f'cRAW stream is {len(data)} bytes; {need} needed for '
            f'{height}x{width}')
    n_groups = width // 32
    if n_groups == 0:
        raise SonyFormatError('cRAW needs at least one 32-column group')
    rows = np.frombuffer(data, np.uint8, count=need).reshape(height, width)
    blk = rows[:, :n_groups * 32].reshape(-1, 16)

    hdr = (blk[:, 0].astype(np.uint32) | blk[:, 1].astype(np.uint32) << 8
           | blk[:, 2].astype(np.uint32) << 16 | blk[:, 3].astype(np.uint32) << 24)
    vmax = (hdr & 0x7FF).astype(np.int32)
    vmin = (hdr >> 11 & 0x7FF).astype(np.int32)
    imax = (hdr >> 22 & 0xF).astype(np.int32)
    imin = (hdr >> 26 & 0xF).astype(np.int32)
    spread = vmax - vmin
    sh = ((spread >= 0x80).astype(np.int32) + (spread >= 0x100)
          + (spread >= 0x200) + (spread >= 0x400))

    bits = np.unpackbits(blk, axis=1, bitorder='little')      # (N, 128)
    deltas = bits[:, 30:128].reshape(-1, 14, 7) @ (1 << np.arange(7))

    # Delta k fills the k-th slot in index order, skipping the max/min slots.
    slots = np.arange(16)[None, :]
    special = (slots == imax[:, None]) | (slots == imin[:, None])
    rank = slots - (slots > imax[:, None]) - (slots > imin[:, None])
    # Corner: imax == imin (only possible for a flat block) leaves rank 14
    # unread in 14-delta blocks; open decoders read past the block there.
    # Our encoder never emits it; decode such slots as min (exact for flat).
    rank = np.clip(rank, 0, 13)
    codes = vmin[:, None] + (np.take_along_axis(deltas, rank, axis=1)
                             << sh[:, None])
    codes = np.minimum(codes, _CODE_MAX)
    codes = np.where(special, vmin[:, None], codes)
    np.put_along_axis(codes, imax[:, None], vmax[:, None], axis=1)

    vals = codes.astype(np.uint16) if curve is None else \
        _codes_to_values(codes, curve)
    out = np.zeros((height, width), np.uint16)
    # (group, block parity, slot) → columns: slot s of parity p is 2s + p
    out[:, :n_groups * 32] = (vals.reshape(height, n_groups, 2, 16)
                              .transpose(0, 1, 3, 2)
                              .reshape(height, n_groups * 32))
    return out


def encode(mosaic, curve=None):
    """Encode a uint16 mosaic into the cRAW block stream (bytes).

    Without ``curve`` the mosaic must already hold 11-bit codes; with it the
    values are inverse-mapped through the tone curve first. Lossy: deltas
    quantize by at most ``2**sh - 1`` in the coded domain (the max/min pixel
    of every block is exact), plus the curve's step size when mapping back.
    """
    mosaic = np.asarray(mosaic, np.uint16)
    h, w = mosaic.shape
    if w % 32:
        raise SonyFormatError('cRAW encoding needs width % 32 == 0')
    codes = (_values_to_codes(mosaic, curve) if curve is not None
             else mosaic).astype(np.int32)
    if codes.max(initial=0) > _CODE_MAX:
        raise SonyFormatError('cRAW codes exceed the 11-bit coded domain')

    # (row, group, parity, slot): column 2*slot + parity within each group
    blk = (codes.reshape(h, w // 32, 16, 2).transpose(0, 1, 3, 2)
           .reshape(-1, 16))
    vmax = blk.max(axis=1)
    vmin = blk.min(axis=1)
    imax = blk.argmax(axis=1).astype(np.int32)
    imin = blk.argmin(axis=1).astype(np.int32)
    flat = imax == imin                       # all-equal block: argmin==argmax
    imin = np.where(flat, (imax + 1) % 16, imin)
    spread = vmax - vmin
    sh = ((spread >= 0x80).astype(np.int32) + (spread >= 0x100)
          + (spread >= 0x200) + (spread >= 0x400))
    deltas = np.minimum((blk - vmin[:, None]) >> sh[:, None], 0x7F)

    # The 14 deltas are the non-special slots in slot order; boolean masking
    # flattens row-major, preserving that order (exactly 2 special per block).
    slots = np.arange(16)[None, :]
    special = (slots == imax[:, None]) | (slots == imin[:, None])
    packed14 = deltas[~special].reshape(-1, 14).astype(np.uint8)

    hdr = (vmax.astype(np.uint32) | vmin.astype(np.uint32) << 11
           | imax.astype(np.uint32) << 22 | imin.astype(np.uint32) << 26)
    bits = np.empty((len(blk), 128), np.uint8)
    bits[:, :30] = (hdr[:, None] >> np.arange(30)) & 1
    bits[:, 30:] = ((packed14[:, :, None] >> np.arange(7)) & 1).reshape(-1, 98)
    return np.packbits(bits, axis=1, bitorder='little').tobytes()


# ----------------------------------------------------------------------------------
# SR2 private-block crypto (tags 0x7200/0x7201/0x7221)
# ----------------------------------------------------------------------------------

def _keystream_pad(key):
    pad = [0] * 128
    k = key & 0xFFFFFFFF
    for p in range(4):
        k = (k * 48828125 + 1) & 0xFFFFFFFF
        pad[p] = k
    pad[3] = (pad[3] << 1 | (pad[0] ^ pad[2]) >> 31) & 0xFFFFFFFF
    for p in range(4, 127):
        pad[p] = ((pad[p - 1] ^ pad[p - 2]) << 1
                  | (pad[p - 3] ^ pad[p - 4]) >> 31) & 0xFFFFFFFF
    return pad


def decrypt(data, key):
    """XOR-decrypt (= encrypt; the cipher is symmetric) an SR2 private block.

    The keystream is dcraw's ``sony_decrypt`` lagged-Fibonacci generator: a
    127-word pad seeded from ``key`` by a LCG, then
    ``pad[(p-1) & 127] = pad[p & 127] ^ pad[(p+64) & 127]`` per output word,
    XORed against the data read as big-endian uint32. A non-multiple-of-4
    tail is passed through untouched (real blocks are word-aligned).
    """
    pad = _keystream_pad(key)
    n = len(data) // 4
    words = np.frombuffer(data, '>u4', count=n).astype(np.int64)
    stream = np.empty(n, np.int64)
    for i in range(n):
        p = 128 + i
        w = pad[p & 127] ^ pad[(p + 64) & 127]
        pad[(p - 1) & 127] = w
        stream[i] = w
    out = (words ^ stream).astype('>u4').tobytes()
    return out + data[4 * n:]
