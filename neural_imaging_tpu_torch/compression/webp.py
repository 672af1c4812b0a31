"""
WebP (VP8 intra) through the system's ``libwebp``, bound with ``ctypes``:
the codec of the rate-distortion sweep's WebP leg, in place of Pillow,
which the GPU machine lacks. The JAX package's leg saves through Pillow with
``quality=q, method=4``; ``WebPEncodeRGB`` encodes with libwebp's default
configuration at quality ``q``, whose method is 4, and gives the same bytes.
libwebp's simple API has no structures, so nothing here depends on a layout.
"""
import ctypes as ct
import ctypes.util
import functools

import numpy as np


class WebPError(RuntimeError):
    pass


@functools.lru_cache()
def library():
    """The system's libwebp typed for ``ctypes``; raises WebPError naming
    the reason when it does not load."""
    name = ctypes.util.find_library('webp') or 'libwebp.so.7'
    try:
        lib = ct.CDLL(name)
    except OSError as e:
        raise WebPError(f'libwebp not loadable: {e}') from e
    u8p, ip = ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int)
    lib.WebPGetEncoderVersion.restype = ct.c_int
    lib.WebPEncodeRGB.restype = ct.c_size_t
    lib.WebPEncodeRGB.argtypes = [ct.c_void_p, ct.c_int, ct.c_int, ct.c_int, ct.c_float,
                                  ct.POINTER(u8p)]
    lib.WebPDecodeRGB.restype = u8p
    lib.WebPDecodeRGB.argtypes = [ct.c_char_p, ct.c_size_t, ip, ip]
    lib.WebPFree.argtypes = [ct.c_void_p]
    return lib


def version():
    """libwebp's encoder version as 'major.minor.revision'."""
    v = library().WebPGetEncoderVersion()
    return f'{v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}'


def encode(img_u8, quality):
    """An (h, w, 3) uint8 RGB image as a lossy WebP file at ``quality`` 0-100."""
    lib = library()
    image = np.ascontiguousarray(img_u8)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f'Expected an (h, w, 3) uint8 image, got {image.dtype} {image.shape}')
    h, w, _ = image.shape
    out = ct.POINTER(ct.c_uint8)()
    n = lib.WebPEncodeRGB(image.ctypes.data, w, h, 3 * w, float(quality), ct.byref(out))
    if not n:
        raise WebPError(f'WebPEncodeRGB failed on a {h}x{w} image at quality {quality}')
    try:
        return ct.string_at(out, n)
    finally:
        lib.WebPFree(out)


def decode(buf):
    """A WebP file's pixels as (h, w, 3) uint8 RGB."""
    lib = library()
    w, h = ct.c_int(), ct.c_int()
    pixels = lib.WebPDecodeRGB(bytes(buf), len(buf), ct.byref(w), ct.byref(h))
    if not pixels:
        raise WebPError('WebPDecodeRGB failed')
    try:
        return np.ctypeslib.as_array(pixels, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.WebPFree(pixels)
