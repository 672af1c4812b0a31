"""
BMP reading without a library, in place of imageio (through PIL), which the
GPU machine lacks: the images of a rate-distortion sweep directory may be
BMP (``compression/ratedistortion.py``).

:func:`read_bmp` gives the array that ``imageio.imread`` gives for:
- BI_RGB at 1, 4 and 8 bits with a palette, and at 16 (5-5-5), 24 and 32 bits;
- BI_BITFIELDS at 16 and 32 bits, with any contiguous masks;
- bottom-up and top-down rows, each padded to a multiple of 4 bytes;
- the 40-byte info header and its 52, 56, 108 and 124-byte successors.

As PIL reads them: a palette whose entries are all gray (entry i = (i, i, i),
or black and white at 1 bit) is dropped, so the image is gray, (h, w)
uint8, or bool at 1 bit; any other palette gives RGB; 32-bit BI_RGB drops
its fourth byte; a 32-bit image keeps alpha, (h, w, 4), only where its
bitfields name an alpha mask; an n-bit field v becomes v * 255 // (2^n - 1).
Run-length coded files (BI_RLE8, BI_RLE4) and anything else raise
``ValueError`` naming the case.
"""
import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
COMPRESSION_NAMES = {BI_RLE8: 'BI_RLE8', BI_RLE4: 'BI_RLE4', 4: 'BI_JPEG', 5: 'BI_PNG'}
INFO_HEADERS = (40, 52, 56, 108, 124)
# BI_RGB at 16 bits is 5-5-5
RGB555 = (0x7C00, 0x3E0, 0x1F, 0)


def _field(values, mask):
    """The field of ``mask`` in ``values``, scaled to 0-255."""
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    if top & (top + 1):
        raise ValueError(f'BMP: bitfield mask {mask:#x} is not contiguous')
    field = (values >> shift) & top
    return (field * 255 // top).astype(np.uint8)


def read_bmp(filename):
    """A BMP image as imageio reads it: (h, w) uint8 gray (bool at 1 bit),
    (h, w, 3) uint8 RGB or (h, w, 4) uint8 RGBA."""
    with open(filename, 'rb') as f:
        blob = f.read()
    if blob[:2] != b'BM' or len(blob) < 18:
        raise ValueError(f'{filename}: not a BMP file')
    offset, size = struct.unpack_from('<II', blob, 10)
    if size not in INFO_HEADERS:
        raise ValueError(f'{filename}: BMP with a {size}-byte header is not supported')
    try:
        width, height, planes, bits, compression = struct.unpack_from('<iiHHI', blob, 18)
        colours, = struct.unpack_from('<I', blob, 46)
        masks = None
        if compression == BI_BITFIELDS:
            # after a 40-byte header: red, green, blue; in the 56-byte and later: alpha too
            n_masks = 4 if size >= 56 else 3
            masks = struct.unpack_from(f'<{n_masks}I', blob, 54) + (0,) * (4 - n_masks)
    except struct.error as e:
        raise ValueError(f'{filename}: truncated BMP header') from e
    if compression in COMPRESSION_NAMES:
        raise ValueError(f'{filename}: {COMPRESSION_NAMES[compression]} (compressed) BMP is not '
                         'supported')
    if compression not in (BI_RGB, BI_BITFIELDS):
        raise ValueError(f'{filename}: BMP compression {compression} is not supported')
    if masks is not None and bits not in (16, 32):
        raise ValueError(f'{filename}: BI_BITFIELDS BMP at {bits} bits is not supported')
    if bits not in (1, 4, 8, 16, 24, 32) or planes != 1 or width <= 0 or height == 0:
        raise ValueError(f'{filename}: BMP of {bits} bits, {planes} planes and size {width}x'
                         f'{height} is not supported')
    top_down, height = height < 0, abs(height)
    stride = (width * bits + 31) // 32 * 4
    if offset + stride * height > len(blob):
        raise ValueError(f'{filename}: truncated BMP pixel data')
    rows = np.frombuffer(blob, np.uint8, count=stride * height, offset=offset)
    rows = rows.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]

    if bits <= 8:
        n = colours or 1 << bits
        if n > 1 << bits or 14 + size + 4 * n > offset:
            raise ValueError(f'{filename}: a palette of {n} colours does not fit {bits} bits '
                             'or the file')
        table = np.frombuffer(blob, np.uint8, count=4 * n, offset=14 + size)
        table = table.reshape(n, 4)[:, 2::-1]          # BGRX → RGB
        if bits < 8:
            index = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(height, width, bits)
            index = (index * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(
                axis=2, dtype=np.uint8)
        else:
            index = rows[:, :width]
        gray_levels = (0, 255) if n == 2 else range(n)
        if all(tuple(table[i]) == (v, v, v) for i, v in enumerate(gray_levels)):
            return index.astype(bool) if n == 2 else index.copy()
        padded = np.zeros((256, 3), np.uint8)              # indices past the table are black
        padded[:n] = table
        return padded[index]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[..., ::-1])
    if bits == 32 and masks is None:
        return np.ascontiguousarray(rows[:, :4 * width].reshape(height, width, 4)[..., 2::-1])
    dtype = '<u2' if bits == 16 else '<u4'
    values = rows[:, :width * bits // 8].copy().view(dtype).astype(np.int64)
    r_mask, g_mask, b_mask, a_mask = masks or RGB555
    if not (r_mask and g_mask and b_mask):
        raise ValueError(f'{filename}: BMP bitfields with an empty colour mask')
    channels = [_field(values, m) for m in (r_mask, g_mask, b_mask)]
    if bits == 32 and a_mask:
        channels.append(_field(values, a_mask))
    return np.stack(channels, axis=-1)
