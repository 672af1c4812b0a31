"""
PNG reading and writing with the standard library's ``zlib``, in place of
imageio and PIL, which the GPU machine lacks.

``read_png`` decodes 8-bit gray, RGB and RGBA images, non-interlaced, with
any of the five row filters; it raises ``ValueError`` on anything else
(palette, 16-bit, gray with alpha, Adam7 interlacing). Rows filtered with
None, Sub or Up are undone with whole-row numpy operations; Average and
Paeth rows depend on their own left neighbours and are undone byte by byte
in Python (about 0.1 s for a 256x384 RGB image made only of such rows).
``write_png`` writes 8-bit gray, RGB or RGBA with no row filter.
"""
import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type → channels, for 8-bit samples
CHANNELS = {0: 1, 2: 3, 6: 4}
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(blob):
    """(type, data) of every chunk, checking each CRC."""
    pos = len(SIGNATURE)
    while pos < len(blob):
        if pos + 8 > len(blob):
            raise ValueError('PNG: truncated chunk header')
        length, kind = struct.unpack('>I4s', blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(blob):
            raise ValueError(f'PNG: truncated {kind!r} chunk')
        crc, = struct.unpack('>I', blob[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f'PNG: bad CRC in the {kind!r} chunk')
        yield kind, data
        pos += 12 + length
        if kind == b'IEND':
            return


def _unfilter_loop(kind, row, prev, bpp):
    """An Average or Paeth row, byte by byte (each byte needs its decoded
    left neighbour)."""
    out = bytearray(row)
    up = prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == AVERAGE:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), dtype=np.uint8)


def _unfilter(raw, height, stride, bpp):
    """Undo the row filters of the decompressed image data."""
    rows = np.frombuffer(raw, dtype=np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f'PNG: {rows.size} bytes of image data, expected {height * (stride + 1)}')
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, row = int(rows[y, 0]), rows[y, 1:]
        if kind == NONE:
            out[y] = row
        elif kind == SUB:
            # out[x] = row[x] + out[x - bpp]: a running sum per channel, mod 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == UP:
            out[y] = row + prev
        elif kind in (AVERAGE, PAETH):
            out[y] = _unfilter_loop(kind, row, prev, bpp)
        else:
            raise ValueError(f'PNG: unknown row filter {kind} in row {y}')
        prev = out[y]
    return out


def read_png(filename):
    """An 8-bit PNG as a uint8 array: (h, w) for gray, (h, w, 3) for RGB,
    (h, w, 4) for RGBA."""
    with open(filename, 'rb') as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f'{filename}: not a PNG file')
    header, data = None, []
    for kind, chunk in _chunks(blob):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', chunk)
        elif kind == b'IDAT':
            data.append(chunk)
    if header is None:
        raise ValueError(f'{filename}: PNG without an IHDR chunk')
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in CHANNELS:
        raise ValueError(f'{filename}: PNG of bit depth {depth} and colour type {colour} is not '
                         'supported; only 8-bit gray (0), RGB (2) and RGBA (6)')
    if interlace != 0:
        raise ValueError(f'{filename}: interlaced (Adam7) PNG is not supported')
    if compression != 0 or filtering != 0:
        raise ValueError(f'{filename}: unknown PNG compression {compression} or filtering '
                         f'{filtering} method')
    channels = CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b''.join(data)), height, width * channels, channels)
    return pixels.reshape(height, width) if channels == 1 else \
        pixels.reshape(height, width, channels)


def _chunk(kind, data):
    return struct.pack('>I', len(data)) + kind + data + struct.pack('>I', zlib.crc32(kind + data))


def write_png(filename, image):
    """Write a uint8 image, (h, w), (h, w, 3) or (h, w, 4), as an 8-bit PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f'write_png takes uint8 images, got {image.dtype}')
    colour = {2: 0, 3: {1: 0, 3: 2, 4: 6}.get(image.shape[-1])}.get(image.ndim)
    if colour is None:
        raise ValueError(f'write_png takes (h, w), (h, w, 3) or (h, w, 4), got {image.shape}')
    height, width = image.shape[:2]
    rows = image.reshape(height, -1)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)  # filter None
    with open(filename, 'wb') as f:
        f.write(SIGNATURE
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, colour, 0, 0, 0))
                + _chunk(b'IDAT', zlib.compress(filtered.tobytes()))
                + _chunk(b'IEND', b''))
