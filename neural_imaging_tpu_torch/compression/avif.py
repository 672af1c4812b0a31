"""
AVIF (AV1 intra) through the system's ``libavif``, bound with ``ctypes``:
the codec of the rate-distortion sweep's AVIF leg, in place of Pillow, which
the GPU machine lacks. It encodes as the JAX package's leg does through
Pillow (``save(..., 'AVIF', quality=q, speed=6)``): 8-bit 4:2:0 YUV, full
range, BT.709 primaries, the sRGB transfer, BT.601 matrix coefficients,
``AVIF_CODEC_CHOICE_AUTO``, one encoder thread for each core the process may
use. ``decode`` converts to 8-bit RGB with libavif's default upsampling.

libavif before 1.0 has no ``quality`` field; there the quality maps to a
quantizer as libavif 1.x maps it, ``((100 - q) * 63 + 50) // 100``, which
is given to the AV1 encoder as its ``cq-level`` with the quantizer range left
at 0-63 (1.x's defaults). The bytes are not Pillow's (its libavif and
libaom are other versions), but near them.

``avifImage``, ``avifRGBImage`` and ``avifEncoder`` change layout between
libavif versions. The loader reads ``avifVersion()`` and knows the layout of
0.11 only; it refuses any other version, and it checks that layout where the
library writes it: the defaults that ``avifImageCreate``,
``avifRGBImageSetDefaults`` and ``avifEncoderCreate`` write must be at the
offsets used here, and ``avifRGBImageSetDefaults`` must write no byte past
the structure.
"""
import ctypes as ct
import ctypes.util
import functools
import os
import struct

import numpy as np

AVIF_PIXEL_FORMAT_YUV420 = 3
AVIF_RANGE_FULL = 1
AVIF_RGB_FORMAT_RGB, AVIF_RGB_FORMAT_RGBA = 0, 1
AVIF_CODEC_CHOICE_AUTO = 0
AVIF_COLOR_PRIMARIES_BT709, AVIF_TRANSFER_CHARACTERISTICS_SRGB = 1, 13
AVIF_MATRIX_COEFFICIENTS_BT601 = 6
UNSPECIFIED = 2
THREADS = len(os.sched_getaffinity(0))

# byte offsets of the fields used here, by libavif major.minor
LAYOUTS = {
    (0, 11): {
        # avifImage: uint32 width, height, depth; enum yuvFormat, yuvRange, ...;
        # uint16 colorPrimaries, transferCharacteristics, matrixCoefficients
        'image': {'width': 0, 'height': 4, 'depth': 8, 'yuvFormat': 12, 'yuvRange': 16,
                  'colorPrimaries': 104, 'transferCharacteristics': 106,
                  'matrixCoefficients': 108},
        # avifRGBImage: uint32 width, height, depth; enum format; six enums and
        # flags; uint8_t* pixels; uint32 rowBytes
        'rgb': {'width': 0, 'height': 4, 'depth': 8, 'format': 12, 'pixels': 40,
                'rowBytes': 48, 'size': 56},
        # avifEncoder: enum codecChoice; int maxThreads, speed, keyframeInterval;
        # uint64 timescale; int minQuantizer, maxQuantizer, minQuantizerAlpha,
        # maxQuantizerAlpha
        'encoder': {'codecChoice': 0, 'maxThreads': 4, 'speed': 8, 'keyframeInterval': 12,
                    'timescale': 16, 'minQuantizer': 24, 'maxQuantizer': 28,
                    'minQuantizerAlpha': 32, 'maxQuantizerAlpha': 36},
    },
}


class AVIFError(RuntimeError):
    pass


class _RWData(ct.Structure):
    _fields_ = [('data', ct.POINTER(ct.c_uint8)), ('size', ct.c_size_t)]


def _get(address, offset, fmt):
    return struct.unpack(fmt, ct.string_at(address + offset, struct.calcsize(fmt)))[0]


def _put(address, offset, fmt, value):
    data = struct.pack(fmt, value)
    ct.memmove(address + offset, data, len(data))


def _check_layout(lib, layout):
    """Hold ``layout`` to the defaults the library writes; raises AVIFError
    where they differ."""
    image = lib.avifImageCreate(11, 7, 8, AVIF_PIXEL_FORMAT_YUV420)
    enc = lib.avifEncoderCreate()
    try:
        im = layout['image']
        found = {k: _get(image, im[k], '<I') for k in ('width', 'height', 'depth', 'yuvFormat',
                                                        'yuvRange')}
        found.update({k: _get(image, im[k], '<H') for k in (
            'colorPrimaries', 'transferCharacteristics', 'matrixCoefficients')})
        want = {'width': 11, 'height': 7, 'depth': 8, 'yuvFormat': AVIF_PIXEL_FORMAT_YUV420,
                'yuvRange': AVIF_RANGE_FULL, 'colorPrimaries': UNSPECIFIED,
                'transferCharacteristics': UNSPECIFIED, 'matrixCoefficients': UNSPECIFIED}
        rgb_layout = layout['rgb']
        rgb = (ct.c_ubyte * (rgb_layout['size'] + 64))(*([0xA5] * (rgb_layout['size'] + 64)))
        lib.avifRGBImageSetDefaults(rgb, image)
        address = ct.addressof(rgb)
        found.update({f'rgb.{k}': _get(address, rgb_layout[k], '<I')
                      for k in ('width', 'height', 'depth', 'format', 'rowBytes')})
        found['rgb.pixels'] = _get(address, rgb_layout['pixels'], '<Q')
        found['rgb.written'] = len(bytes(rgb).rstrip(b'\xa5')) <= rgb_layout['size']
        want.update({'rgb.width': 11, 'rgb.height': 7, 'rgb.depth': 8,
                     'rgb.format': AVIF_RGB_FORMAT_RGBA, 'rgb.rowBytes': 0, 'rgb.pixels': 0,
                     'rgb.written': True})
        e = layout['encoder']
        found.update({f'encoder.{k}': _get(enc, e[k], '<i') for k in (
            'codecChoice', 'maxThreads', 'speed', 'keyframeInterval', 'minQuantizer',
            'maxQuantizer', 'minQuantizerAlpha', 'maxQuantizerAlpha')})
        found['encoder.timescale'] = _get(enc, e['timescale'], '<Q')
        want.update({'encoder.codecChoice': AVIF_CODEC_CHOICE_AUTO, 'encoder.maxThreads': 1,
                     'encoder.speed': -1, 'encoder.keyframeInterval': 0,
                     'encoder.minQuantizer': 0, 'encoder.maxQuantizer': 0,
                     'encoder.minQuantizerAlpha': 0, 'encoder.maxQuantizerAlpha': 0,
                     'encoder.timescale': 1})
        wrong = {k: (found[k], want[k]) for k in want if found[k] != want[k]}
        if wrong:
            raise AVIFError(f'libavif layout mismatch (found, expected): {wrong}; refusing to '
                            'encode with unverified struct offsets')
    finally:
        lib.avifEncoderDestroy(enc)
        lib.avifImageDestroy(image)


@functools.lru_cache()
def library():
    """The system's libavif typed for ``ctypes``, its version known and its
    layout verified. Raises AVIFError naming the reason when it does not
    load."""
    name = ctypes.util.find_library('avif') or 'libavif.so.15'
    try:
        lib = ct.CDLL(name)
    except OSError as e:
        raise AVIFError(f'libavif not loadable: {e}') from e
    vp, u32 = ct.c_void_p, ct.c_uint32
    lib.avifVersion.restype = ct.c_char_p
    version = lib.avifVersion().decode()
    key = tuple(int(x) for x in version.split('.')[:2])
    if key not in LAYOUTS:
        raise AVIFError(f'libavif {version}: the layout of its structures is known only for '
                        + ', '.join(f'{a}.{b}.x' for a, b in LAYOUTS))
    lib.avifCodecVersions.argtypes = [ct.c_char_p]
    lib.avifResultToString.restype = ct.c_char_p
    lib.avifResultToString.argtypes = [ct.c_int]
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [u32, u32, u32, ct.c_int]
    lib.avifImageCreateEmpty.restype = vp
    lib.avifImageDestroy.argtypes = [vp]
    lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
    lib.avifRGBImageAllocatePixels.argtypes = [vp]
    lib.avifRGBImageFreePixels.argtypes = [vp]
    lib.avifImageRGBToYUV.restype = ct.c_int
    lib.avifImageRGBToYUV.argtypes = [vp, vp]
    lib.avifImageYUVToRGB.restype = ct.c_int
    lib.avifImageYUVToRGB.argtypes = [vp, vp]
    lib.avifEncoderCreate.restype = vp
    lib.avifEncoderDestroy.argtypes = [vp]
    lib.avifEncoderSetCodecSpecificOption.argtypes = [vp, ct.c_char_p, ct.c_char_p]
    lib.avifEncoderWrite.restype = ct.c_int
    lib.avifEncoderWrite.argtypes = [vp, vp, ct.POINTER(_RWData)]
    lib.avifRWDataFree.argtypes = [ct.POINTER(_RWData)]
    lib.avifDecoderCreate.restype = vp
    lib.avifDecoderDestroy.argtypes = [vp]
    lib.avifDecoderReadMemory.restype = ct.c_int
    lib.avifDecoderReadMemory.argtypes = [vp, vp, ct.c_char_p, ct.c_size_t]
    layout = LAYOUTS[key]
    _check_layout(lib, layout)
    codecs = ct.create_string_buffer(256)
    lib.avifCodecVersions(codecs)
    lib.version, lib.codecs, lib.layout = version, codecs.value.decode(), layout
    return lib


def version():
    """libavif's version and its codecs' ('0.11.1 (aom [enc/dec]:v3.6.0, ...)')."""
    lib = library()
    return f'{lib.version} ({lib.codecs})'


def quantizer(quality):
    """libavif 1.x's quantizer for a quality 0-100."""
    quality = min(max(int(quality), 0), 100)
    return ((100 - quality) * 63 + 50) // 100


def _check(lib, result, what):
    if result != 0:
        raise AVIFError(f'{what} failed: {lib.avifResultToString(result).decode()}')


def _rgb_image(lib, image):
    """An avifRGBImage buffer set to 8-bit RGB for ``image`` (its pixels
    unset)."""
    layout = lib.layout['rgb']
    rgb = (ct.c_ubyte * layout['size'])()
    lib.avifRGBImageSetDefaults(rgb, image)
    address = ct.addressof(rgb)
    _put(address, layout['depth'], '<I', 8)
    _put(address, layout['format'], '<I', AVIF_RGB_FORMAT_RGB)
    return rgb, address


def encode(img_u8, quality, speed=6):
    """An (h, w, 3) uint8 RGB image as an AVIF file at ``quality`` 0-100."""
    lib = library()
    pixels = np.ascontiguousarray(img_u8)
    if pixels.dtype != np.uint8 or pixels.ndim != 3 or pixels.shape[-1] != 3:
        raise ValueError(f'Expected an (h, w, 3) uint8 image, got {pixels.dtype} {pixels.shape}')
    h, w, _ = pixels.shape
    im, e = lib.layout['image'], lib.layout['encoder']
    image = lib.avifImageCreate(w, h, 8, AVIF_PIXEL_FORMAT_YUV420)
    encoder = lib.avifEncoderCreate()
    output = _RWData()
    try:
        _put(image, im['yuvRange'], '<I', AVIF_RANGE_FULL)
        _put(image, im['colorPrimaries'], '<H', AVIF_COLOR_PRIMARIES_BT709)
        _put(image, im['transferCharacteristics'], '<H', AVIF_TRANSFER_CHARACTERISTICS_SRGB)
        _put(image, im['matrixCoefficients'], '<H', AVIF_MATRIX_COEFFICIENTS_BT601)
        rgb, address = _rgb_image(lib, image)
        _put(address, lib.layout['rgb']['pixels'], '<Q', pixels.ctypes.data)
        _put(address, lib.layout['rgb']['rowBytes'], '<I', 3 * w)
        _check(lib, lib.avifImageRGBToYUV(image, rgb), 'avifImageRGBToYUV')
        _put(encoder, e['codecChoice'], '<i', AVIF_CODEC_CHOICE_AUTO)
        _put(encoder, e['maxThreads'], '<i', THREADS)
        _put(encoder, e['speed'], '<i', int(speed))
        _put(encoder, e['minQuantizer'], '<i', 0)
        _put(encoder, e['maxQuantizer'], '<i', 63)
        lib.avifEncoderSetCodecSpecificOption(encoder, b'end-usage', b'q')
        lib.avifEncoderSetCodecSpecificOption(encoder, b'cq-level',
                                              str(quantizer(quality)).encode())
        _check(lib, lib.avifEncoderWrite(encoder, image, ct.byref(output)), 'avifEncoderWrite')
        return ct.string_at(output.data, output.size)
    finally:
        lib.avifRWDataFree(ct.byref(output))
        lib.avifEncoderDestroy(encoder)
        lib.avifImageDestroy(image)


def decode(buf):
    """An AVIF file's pixels as (h, w, 3) uint8 RGB."""
    lib = library()
    decoder = lib.avifDecoderCreate()
    image = lib.avifImageCreateEmpty()
    rgb = None
    try:
        data = bytes(buf)
        _check(lib, lib.avifDecoderReadMemory(decoder, image, data, len(data)),
               'avifDecoderReadMemory')
        im = lib.layout['image']
        h, w = _get(image, im['height'], '<I'), _get(image, im['width'], '<I')
        rgb, address = _rgb_image(lib, image)
        lib.avifRGBImageAllocatePixels(rgb)
        _check(lib, lib.avifImageYUVToRGB(image, rgb), 'avifImageYUVToRGB')
        layout = lib.layout['rgb']
        pixels, row_bytes = _get(address, layout['pixels'], '<Q'), _get(address,
                                                                         layout['rowBytes'], '<I')
        rows = np.frombuffer(ct.string_at(pixels, row_bytes * h), np.uint8).reshape(h, row_bytes)
        return rows[:, :3 * w].reshape(h, w, 3).copy()
    finally:
        if rgb is not None:
            lib.avifRGBImageFreePixels(rgb)
        lib.avifImageDestroy(image)
        lib.avifDecoderDestroy(decoder)
