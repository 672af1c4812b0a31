"""
PNG reading and writing with the standard library's ``zlib``, in place of
imageio and PIL, which the GPU machine lacks.

``read_png`` decodes non-interlaced 8-bit gray, gray with alpha, RGB and
RGBA images and palette images of 1, 2, 4 or 8 bits, with any of the five
row filters, as imageio reads them: a palette image comes back as RGB
through its palette (imageio drops a ``tRNS`` table there, and so does
``read_png``). It raises ``ValueError`` on anything else (16-bit samples,
gray below 8 bits, Adam7 interlacing). The row filters are undone in one
call of the native ``csrc/png_unfilter.cpp``, built at first use by
``utils/native.py`` into ``neural_imaging_tpu_torch/_build/`` and loaded
with ``ctypes``; a failed build raises. :func:`_unfilter` is its plain
version (whole-row numpy for None, Sub and Up, a Python loop a byte for
Average and Paeth), which the tests hold it against and nothing else calls.
``write_png`` writes 8-bit gray, RGB or RGBA with no row filter.
"""
import ctypes
import functools
import struct
import zlib

import numpy as np

from neural_imaging_tpu_torch.ops.hopper._build import PACKAGE_DIR
from neural_imaging_tpu_torch.utils import native

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type → samples a pixel: gray, RGB, palette index, gray + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PALETTE = 3
NONE, SUB, UP, AVERAGE, PAETH = range(5)
SOURCE = PACKAGE_DIR / 'csrc' / 'png_unfilter.cpp'


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
    """Undo the row filters of the decompressed image data: the plain
    version of :func:`unfilter`."""
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


def library_path():
    """Where the library built from ``csrc/png_unfilter.cpp`` lives."""
    return native.library_path(SOURCE, 'png_unfilter')


@functools.lru_cache()
def library():
    """The native unfilter, ``pu_unfilter``, typed for ``ctypes``; built
    first if its library is missing (a failed build raises)."""
    lib = ctypes.CDLL(str(native.build(SOURCE, 'png_unfilter')))
    lib.pu_unfilter.restype = ctypes.c_long
    lib.pu_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
                                ctypes.c_void_p]
    return lib


def unfilter(raw, height, stride, bpp):
    """Undo the row filters of the decompressed image data in the native
    library: ``height`` rows of a filter byte and ``stride`` bytes, ``bpp``
    bytes a pixel. Returns (height, stride) uint8."""
    raw = bytes(raw)
    if len(raw) != height * (stride + 1):
        raise ValueError(f'PNG: {len(raw)} bytes of image data, expected {height * (stride + 1)}')
    out = np.empty((height, stride), dtype=np.uint8)
    bad = library().pu_unfilter(raw, height, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f'PNG: unknown row filter {raw[(bad - 1) * (stride + 1)]} in row '
                         f'{bad - 1}')
    return out


def read_png(filename):
    """A PNG as a uint8 array, as imageio reads it: (h, w) for gray, (h, w, 2)
    for gray with alpha, (h, w, 3) for RGB and palette images, (h, w, 4) for
    RGBA."""
    with open(filename, 'rb') as f:
        blob = f.read()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f'{filename}: not a PNG file')
    header, data, palette = None, [], None
    for kind, chunk in _chunks(blob):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', chunk)
        elif kind == b'PLTE':
            palette = chunk
        elif kind == b'IDAT':
            data.append(chunk)
    if header is None:
        raise ValueError(f'{filename}: PNG without an IHDR chunk')
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in CHANNELS or (depth != 8 and not (colour == PALETTE and depth in (1, 2, 4))):
        raise ValueError(f'{filename}: PNG of bit depth {depth} and colour type {colour} is not '
                         'supported; only 8-bit gray (0), RGB (2), gray with alpha (4) and RGBA '
                         '(6), and palette (3) of 1, 2, 4 or 8 bits')
    if interlace != 0:
        raise ValueError(f'{filename}: interlaced (Adam7) PNG is not supported')
    if compression != 0 or filtering != 0:
        raise ValueError(f'{filename}: unknown PNG compression {compression} or filtering '
                         f'{filtering} method')
    if colour == PALETTE and (palette is None or len(palette) % 3):
        raise ValueError(f'{filename}: palette PNG without a valid PLTE chunk')
    channels = CHANNELS[colour]
    stride = (width * channels * depth + 7) // 8
    pixels = unfilter(zlib.decompress(b''.join(data)), height, stride,
                      max(1, channels * depth // 8))
    if colour == PALETTE:
        if depth < 8:
            pixels = np.unpackbits(pixels, axis=1).reshape(height, -1, depth)[:, :width]
            pixels = (pixels * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
                axis=2, dtype=np.uint8)
        table = np.zeros((256, 3), np.uint8)        # entries past the PLTE's are black
        table[:len(palette) // 3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        return table[pixels]
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
