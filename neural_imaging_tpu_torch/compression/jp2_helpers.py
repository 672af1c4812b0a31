"""
JPEG 2000 helpers: the codestream's payload count and targeted encoding
through the system's OpenJPEG (``libopenjp2``), bound with ``ctypes``. Port
of ``neural_imaging_tpu/compression/jp2_helpers.py``, which encodes through
OpenCV; the GPU machine has no OpenCV, and OpenCV's JPEG 2000 writer is
OpenJPEG driven as :func:`encode_jp2` drives it.

- :func:`jp2_payload_bytes` walks the JP2 boxes (or a raw codestream) and
  sums the ``Psot`` tile-part lengths, a zero ``Psot`` measured to EOC: the
  effective payload, without the main header and the boxes;
- :func:`encode_jp2` encodes an RGB uint8 image as a JP2 file, at a rate or
  at a PSNR found by bisection on the rate knob; :func:`decode_jp2` decodes
  one.

The knob ``q`` in [1, 1000] is OpenCV's ``IMWRITE_JPEG2000_COMPRESSION_X1000``:
one quality layer whose rate is ``tcp_rates[0] = 1000 / q`` (a compression
ratio against the raw 24 bits a pixel) with ``cp_disto_alloc = 1``, and
OpenJPEG's defaults otherwise: the reversible 5/3 wavelet, 6 resolutions
(5 decomposition levels), 64x64 code-blocks, LRCP order, no colour transform
(MCT off). The components are written in R, G, B order, 8-bit unsigned, sRGB.
Both directions run on OpenJPEG's threads, one for each core the process
may use (``opj_codec_set_threads``).

``opj_cparameters_t``, ``opj_image_t``, ``opj_image_comp_t`` and
``opj_image_cmptparm_t`` are declared from OpenJPEG 2.5's ``openjpeg.h``
(the soname has been 7 since 2.0, the layout the same since 2.1). The loader
refuses an ``opj_version()`` whose major version is not 2 or whose minor is
below 1, and it checks the layout where the library writes it: the bytes
that ``opj_set_default_encoder_parameters`` clears must be exactly
``sizeof(opj_cparameters_t)`` and hold its defaults at their offsets, and an
image made by ``opj_image_create`` must hold its component parameters at
theirs.
"""
import ctypes as ct
import ctypes.util
import functools
import os
import struct

import numpy as np

SOC = 0xFF4F
SIZ = 0xFF51
SOT = 0xFF90
SOD = 0xFF93
EOC = 0xFFD9


def _find_codestream(buf):
    """Return the offset of the contiguous codestream inside a JP2 file (or 0 for
    a raw codestream)."""
    if len(buf) >= 2 and struct.unpack('>H', buf[:2])[0] == SOC:
        return 0, len(buf)
    # JP2 box walk: each box is (LBox u32, TBox 4cc[, XLBox u64]) + payload
    pos = 0
    n = len(buf)
    while pos + 8 <= n:
        (lbox,) = struct.unpack_from('>I', buf, pos)
        tbox = buf[pos + 4:pos + 8]
        header = 8
        if lbox == 1:
            (lbox,) = struct.unpack_from('>Q', buf, pos + 8)
            header = 16
        elif lbox == 0:
            lbox = n - pos
        if tbox == b'jp2c':
            return pos + header, pos + lbox
        if lbox < header:
            break
        pos += lbox
    raise ValueError('No JPEG 2000 codestream found (not a JP2 file?)')


def jp2_payload_bytes(data):
    """
    Effective payload size of a JPEG 2000 file/buffer: the sum of all tile-part
    lengths (``Psot``), i.e. entropy-coded data + tile headers, excluding the main
    header and file-format boxes (jpylyzer's ``psot`` accounting).
    """
    if isinstance(data, str):
        with open(data, 'rb') as fh:
            data = fh.read()
    data = bytes(data)
    start, end = _find_codestream(data)

    total = 0
    pos = start
    while pos + 2 <= end:
        (marker,) = struct.unpack_from('>H', data, pos)
        if marker == SOT:
            # Lsot(2) Isot(2) Psot(4) TPsot(1) TNsot(1)
            (psot,) = struct.unpack_from('>I', data, pos + 6)
            if psot == 0:  # last tile-part of the stream: extends to EOC
                psot = (end - 2) - pos
            total += psot
            pos += psot
            continue
        if marker == EOC:
            break
        if marker == SOC:
            pos += 2
            continue
        if pos + 4 > end:
            break
        (seg_len,) = struct.unpack_from('>H', data, pos + 2)
        pos += 2 + seg_len

    if total == 0:
        raise ValueError('No tile-parts found in codestream')
    return total


# ------------------------------------------------------------------ OpenJPEG's ABI

OPJ_PATH_LEN = 4096
OPJ_J2K_MAXRLVLS = 33
JPWL_MAX_NO_TILESPECS = 16
JPWL_MAX_NO_PACKSPECS = 16
OPJ_CODEC_JP2 = 2
OPJ_CLRSPC_SRGB = 1
OPJ_STREAM_CHUNK = 1 << 20
# code-blocks are coded independently, so the bytes do not depend on the count
THREADS = len(os.sched_getaffinity(0))
_u32, _i32 = ct.c_uint32, ct.c_int32


class _Poc(ct.Structure):
    _fields_ = ([(n, _u32) for n in ('resno0', 'compno0', 'layno1', 'resno1', 'compno1',
                                     'layno0', 'precno0', 'precno1')]
                + [('prg1', ct.c_int), ('prg', ct.c_int), ('progorder', ct.c_char * 5),
                   ('tile', _u32)]
                + [(n, _i32) for n in ('tx0', 'tx1', 'ty0', 'ty1')]
                + [(n, _u32) for n in ('layS', 'resS', 'compS', 'prcS', 'layE', 'resE', 'compE',
                                       'prcE', 'txS', 'txE', 'tyS', 'tyE', 'dx', 'dy', 'lay_t',
                                       'res_t', 'comp_t', 'prc_t', 'tx0_t', 'ty0_t')])


class CParameters(ct.Structure):
    """``opj_cparameters_t`` of OpenJPEG 2.1-2.5."""
    _fields_ = [
        ('tile_size_on', ct.c_int), ('cp_tx0', ct.c_int), ('cp_ty0', ct.c_int),
        ('cp_tdx', ct.c_int), ('cp_tdy', ct.c_int), ('cp_disto_alloc', ct.c_int),
        ('cp_fixed_alloc', ct.c_int), ('cp_fixed_quality', ct.c_int),
        ('cp_matrice', ct.c_void_p), ('cp_comment', ct.c_char_p), ('csty', ct.c_int),
        ('prog_order', ct.c_int), ('POC', _Poc * 32), ('numpocs', _u32),
        ('tcp_numlayers', ct.c_int), ('tcp_rates', ct.c_float * 100),
        ('tcp_distoratio', ct.c_float * 100), ('numresolution', ct.c_int),
        ('cblockw_init', ct.c_int), ('cblockh_init', ct.c_int), ('mode', ct.c_int),
        ('irreversible', ct.c_int), ('roi_compno', ct.c_int), ('roi_shift', ct.c_int),
        ('res_spec', ct.c_int), ('prcw_init', ct.c_int * OPJ_J2K_MAXRLVLS),
        ('prch_init', ct.c_int * OPJ_J2K_MAXRLVLS), ('infile', ct.c_char * OPJ_PATH_LEN),
        ('outfile', ct.c_char * OPJ_PATH_LEN), ('index_on', ct.c_int),
        ('index', ct.c_char * OPJ_PATH_LEN), ('image_offset_x0', ct.c_int),
        ('image_offset_y0', ct.c_int), ('subsampling_dx', ct.c_int),
        ('subsampling_dy', ct.c_int), ('decod_format', ct.c_int), ('cod_format', ct.c_int),
        ('jpwl_epc_on', ct.c_int), ('jpwl_hprot_MH', ct.c_int),
        ('jpwl_hprot_TPH_tileno', ct.c_int * JPWL_MAX_NO_TILESPECS),
        ('jpwl_hprot_TPH', ct.c_int * JPWL_MAX_NO_TILESPECS),
        ('jpwl_pprot_tileno', ct.c_int * JPWL_MAX_NO_PACKSPECS),
        ('jpwl_pprot_packno', ct.c_int * JPWL_MAX_NO_PACKSPECS),
        ('jpwl_pprot', ct.c_int * JPWL_MAX_NO_PACKSPECS), ('jpwl_sens_size', ct.c_int),
        ('jpwl_sens_addr', ct.c_int), ('jpwl_sens_range', ct.c_int),
        ('jpwl_sens_MH', ct.c_int), ('jpwl_sens_TPH_tileno', ct.c_int * JPWL_MAX_NO_TILESPECS),
        ('jpwl_sens_TPH', ct.c_int * JPWL_MAX_NO_TILESPECS), ('cp_cinema', ct.c_int),
        ('max_comp_size', ct.c_int), ('cp_rsiz', ct.c_int), ('tp_on', ct.c_char),
        ('tp_flag', ct.c_char), ('tcp_mct', ct.c_char), ('jpip_on', ct.c_int),
        ('mct_data', ct.c_void_p), ('max_cs_size', ct.c_int), ('rsiz', ct.c_uint16)]


class ImageCompParm(ct.Structure):
    """``opj_image_cmptparm_t``."""
    _fields_ = [(n, _u32) for n in ('dx', 'dy', 'w', 'h', 'x0', 'y0', 'prec', 'bpp', 'sgnd')]


class ImageComp(ct.Structure):
    """``opj_image_comp_t``."""
    _fields_ = ([(n, _u32) for n in ('dx', 'dy', 'w', 'h', 'x0', 'y0', 'prec', 'bpp', 'sgnd',
                                     'resno_decoded', 'factor')]
                + [('data', ct.POINTER(_i32)), ('alpha', ct.c_uint16)])


class Image(ct.Structure):
    """``opj_image_t``."""
    _fields_ = [('x0', _u32), ('y0', _u32), ('x1', _u32), ('y1', _u32), ('numcomps', _u32),
                ('color_space', ct.c_int), ('comps', ct.POINTER(ImageComp)),
                ('icc_profile_buf', ct.c_void_p), ('icc_profile_len', _u32)]


# the stream callbacks: read/write(buffer, n, user) → n, skip(n, user) → n,
# seek(position, user) → bool
_READ_WRITE = ct.CFUNCTYPE(ct.c_size_t, ct.c_void_p, ct.c_size_t, ct.c_void_p)
_SKIP = ct.CFUNCTYPE(ct.c_int64, ct.c_int64, ct.c_void_p)
_SEEK = ct.CFUNCTYPE(ct.c_int, ct.c_int64, ct.c_void_p)
_READ_END = ct.c_size_t(-1).value


class OpenJPEGError(RuntimeError):
    pass


def _check_layout(lib):
    """Hold the declared structures to what the library writes; raises
    OpenJPEGError where they differ."""
    size = ct.sizeof(CParameters)
    buf = (ct.c_ubyte * (size + 4096))(*([0xA5] * (size + 4096)))
    lib.opj_set_default_encoder_parameters(buf)
    raw = bytes(buf)
    cleared = len(raw.rstrip(b'\xa5'))
    params = CParameters.from_buffer_copy(raw[:size])
    defaults = {'numresolution': 6, 'cblockw_init': 64, 'cblockh_init': 64, 'prog_order': 0,
                'roi_compno': -1, 'subsampling_dx': 1, 'subsampling_dy': 1,
                'decod_format': -1, 'cod_format': -1, 'tcp_numlayers': 0}
    found = {k: getattr(params, k) for k in defaults}
    if found != defaults or cleared != size:
        raise OpenJPEGError(
            f'opj_cparameters_t layout mismatch: the library cleared {cleared} bytes (declared '
            f'size {size}) and wrote {found}, expected {defaults}; refusing to encode with '
            'unverified struct offsets')
    parm = (ImageCompParm * 2)()
    for i, p in enumerate(parm):
        p.dx, p.dy, p.w, p.h, p.prec, p.bpp = 1, 1, 11 + i, 7 + i, 8, 8
    image = lib.opj_image_create(2, parm, OPJ_CLRSPC_SRGB)
    try:
        im = image.contents
        comps = [im.comps[i] for i in range(2)]
        if (im.numcomps, im.color_space) != (2, OPJ_CLRSPC_SRGB) or \
                [(c.w, c.h, c.prec, c.dx) for c in comps] != [(11, 7, 8, 1), (12, 8, 8, 1)] or \
                not all(c.data for c in comps):
            raise OpenJPEGError('opj_image_t / opj_image_comp_t layout mismatch; refusing to '
                                'encode with unverified struct offsets')
    finally:
        lib.opj_image_destroy(image)


@functools.lru_cache()
def library():
    """The system's libopenjp2 typed for ``ctypes``, its version checked and
    its structures' layout verified. Raises OpenJPEGError naming the reason
    when it does not load."""
    name = ctypes.util.find_library('openjp2') or 'libopenjp2.so.7'
    try:
        lib = ct.CDLL(name)
    except OSError as e:
        raise OpenJPEGError(f'libopenjp2 not loadable: {e}') from e
    vp, b = ct.c_void_p, ct.c_int
    lib.opj_version.restype = ct.c_char_p
    version = lib.opj_version().decode()
    major, minor = (int(x) for x in version.split('.')[:2])
    if major != 2 or minor < 1:
        raise OpenJPEGError(f'libopenjp2 {version}: only the 2.x layout from 2.1 on is known')
    lib.opj_set_default_encoder_parameters.argtypes = [vp]
    lib.opj_set_default_decoder_parameters.argtypes = [vp]
    lib.opj_image_create.restype = ct.POINTER(Image)
    lib.opj_image_create.argtypes = [_u32, ct.POINTER(ImageCompParm), ct.c_int]
    lib.opj_image_destroy.argtypes = [ct.POINTER(Image)]
    lib.opj_create_compress.restype = vp
    lib.opj_create_compress.argtypes = [ct.c_int]
    lib.opj_create_decompress.restype = vp
    lib.opj_create_decompress.argtypes = [ct.c_int]
    lib.opj_destroy_codec.argtypes = [vp]
    lib.opj_codec_set_threads.restype = b
    lib.opj_codec_set_threads.argtypes = [vp, b]
    lib.opj_setup_encoder.restype = b
    lib.opj_setup_encoder.argtypes = [vp, ct.POINTER(CParameters), ct.POINTER(Image)]
    lib.opj_setup_decoder.restype = b
    lib.opj_setup_decoder.argtypes = [vp, vp]
    lib.opj_stream_create.restype = vp
    lib.opj_stream_create.argtypes = [ct.c_size_t, b]
    lib.opj_stream_destroy.argtypes = [vp]
    lib.opj_stream_set_read_function.argtypes = [vp, _READ_WRITE]
    lib.opj_stream_set_write_function.argtypes = [vp, _READ_WRITE]
    lib.opj_stream_set_skip_function.argtypes = [vp, _SKIP]
    lib.opj_stream_set_seek_function.argtypes = [vp, _SEEK]
    lib.opj_stream_set_user_data.argtypes = [vp, vp, vp]
    lib.opj_stream_set_user_data_length.argtypes = [vp, ct.c_uint64]
    lib.opj_start_compress.restype = b
    lib.opj_start_compress.argtypes = [vp, ct.POINTER(Image), vp]
    lib.opj_encode.restype = b
    lib.opj_encode.argtypes = [vp, vp]
    lib.opj_end_compress.restype = b
    lib.opj_end_compress.argtypes = [vp, vp]
    lib.opj_read_header.restype = b
    lib.opj_read_header.argtypes = [vp, vp, ct.POINTER(ct.POINTER(Image))]
    lib.opj_decode.restype = b
    lib.opj_decode.argtypes = [vp, vp, ct.POINTER(Image)]
    lib.opj_end_decompress.restype = b
    lib.opj_end_decompress.argtypes = [vp, vp]
    _check_layout(lib)
    lib.version = version
    return lib


def version():
    """libopenjp2's version string (raises OpenJPEGError if it does not load)."""
    return library().version


class _MemoryStream:
    """An OpenJPEG stream over a Python buffer. The callbacks are kept on the
    object, which the caller keeps alive until the codec is done with it."""

    def __init__(self, lib, data=None):
        self.lib, self.pos = lib, 0
        self.buf = bytearray() if data is None else bytearray(data)
        self.read_cb = _READ_WRITE(self._read)
        self.write_cb = _READ_WRITE(self._write)
        self.skip_cb = _SKIP(self._skip)
        self.seek_cb = _SEEK(self._seek)
        self.stream = lib.opj_stream_create(OPJ_STREAM_CHUNK, int(data is not None))
        if not self.stream:
            raise OpenJPEGError('opj_stream_create failed')
        if data is None:
            lib.opj_stream_set_write_function(self.stream, self.write_cb)
        else:
            lib.opj_stream_set_read_function(self.stream, self.read_cb)
            lib.opj_stream_set_user_data_length(self.stream, len(self.buf))
        lib.opj_stream_set_skip_function(self.stream, self.skip_cb)
        lib.opj_stream_set_seek_function(self.stream, self.seek_cb)
        lib.opj_stream_set_user_data(self.stream, None, None)

    def _read(self, buffer, n, _):
        left = len(self.buf) - self.pos
        if left <= 0:
            return _READ_END
        n = min(n, left)
        ct.memmove(buffer, (ct.c_char * n).from_buffer(self.buf, self.pos), n)
        self.pos += n
        return n

    def _write(self, buffer, n, _):
        end = self.pos + n
        if end > len(self.buf):
            self.buf.extend(bytes(end - len(self.buf)))
        self.buf[self.pos:end] = ct.string_at(buffer, n)
        self.pos = end
        return n

    def _skip(self, n, _):
        if n < 0 and self.pos + n < 0:
            return -1
        self.pos += n
        return n

    def _seek(self, position, _):
        if position < 0:
            return 0
        self.pos = position
        return 1

    def close(self):
        if self.stream:
            self.lib.opj_stream_destroy(self.stream)
            self.stream = None


def _encode(lib, image_u8, q):
    """One JP2 file of an (h, w, 3) uint8 image at knob ``q`` in [1, 1000]."""
    h, w, nc = image_u8.shape
    params = CParameters()
    lib.opj_set_default_encoder_parameters(ct.byref(params))
    params.tcp_rates[0] = 1000.0 / min(max(int(q), 1), 1000)
    params.tcp_numlayers = 1
    params.cp_disto_alloc = 1
    parm = (ImageCompParm * nc)()
    for p in parm:
        p.dx, p.dy, p.w, p.h, p.prec, p.bpp, p.sgnd = 1, 1, w, h, 8, 8, 0
    image = lib.opj_image_create(nc, parm, OPJ_CLRSPC_SRGB)
    if not image:
        raise OpenJPEGError('opj_image_create failed')
    codec, stream = None, None
    try:
        im = image.contents
        im.x0, im.y0, im.x1, im.y1 = 0, 0, w, h
        for c in range(nc):
            np.ctypeslib.as_array(im.comps[c].data, shape=(h, w))[:] = image_u8[..., c]
        codec = lib.opj_create_compress(OPJ_CODEC_JP2)
        if not codec or not lib.opj_setup_encoder(codec, ct.byref(params), image):
            raise OpenJPEGError('opj_setup_encoder failed')
        lib.opj_codec_set_threads(codec, THREADS)
        stream = _MemoryStream(lib)
        if not (lib.opj_start_compress(codec, image, stream.stream)
                and lib.opj_encode(codec, stream.stream)
                and lib.opj_end_compress(codec, stream.stream)):
            raise OpenJPEGError('JPEG 2000 encoding failed')
        return bytes(stream.buf)
    finally:
        if stream is not None:
            stream.close()
        if codec:
            lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


def decode_jp2(data):
    """A JP2 file's pixels as (h, w, c) uint8, components in file order."""
    lib = library()
    codec = lib.opj_create_decompress(OPJ_CODEC_JP2)
    if not codec:
        raise OpenJPEGError('opj_create_decompress failed')
    dparams = (ct.c_ubyte * 16384)()        # opj_dparameters_t is ~8.3 KB in 2.x
    lib.opj_set_default_decoder_parameters(dparams)
    stream = _MemoryStream(lib, bytes(data))
    image = ct.POINTER(Image)()
    try:
        if not lib.opj_setup_decoder(codec, dparams):
            raise OpenJPEGError('opj_setup_decoder failed')
        lib.opj_codec_set_threads(codec, THREADS)
        if not lib.opj_read_header(stream.stream, codec, ct.byref(image)):
            raise OpenJPEGError('opj_read_header failed')
        if not (lib.opj_decode(codec, stream.stream, image)
                and lib.opj_end_decompress(codec, stream.stream)):
            raise OpenJPEGError('JPEG 2000 decoding failed')
        im = image.contents
        planes = []
        for c in range(im.numcomps):
            comp = im.comps[c]
            if comp.prec != 8 or comp.sgnd or (comp.dx, comp.dy) != (1, 1):
                raise OpenJPEGError(f'component {c}: {comp.prec}-bit, signed {comp.sgnd}, '
                                    f'subsampled {comp.dx}x{comp.dy}; only 8-bit unsigned full '
                                    'resolution is decoded')
            planes.append(np.ctypeslib.as_array(comp.data, shape=(comp.h, comp.w)).copy())
        return np.stack(planes, axis=-1).clip(0, 255).astype(np.uint8)
    finally:
        if image:
            lib.opj_image_destroy(image)
        stream.close()
        lib.opj_destroy_codec(codec)


def encode_jp2(image_u8_rgb, rate_bpp=None, psnr_target=None, tol=0.1, max_iter=12):
    """
    Encode an RGB uint8 image as JPEG 2000 through OpenJPEG.

    Exactly one of:
    - ``rate_bpp``: target bits-per-pixel (the knob is a linear rate control:
      q -> q/1000 of the raw size);
    - ``psnr_target``: match the reconstruction PSNR (dB) by bisection on the
      rate knob.

    Returns (buffer_bytes, decoded_rgb_float01).
    """
    if (rate_bpp is None) == (psnr_target is None):
        raise ValueError('Specify exactly one of rate_bpp / psnr_target')
    lib = library()
    image = np.ascontiguousarray(image_u8_rgb)

    def enc(q):
        buf = _encode(lib, image, int(np.clip(q, 1, 1000)))
        return buf, decode_jp2(buf).astype(np.float32) / 255.0

    if rate_bpp is not None:
        # raw size is 24 bpp; quality = fraction-of-raw x 1000
        return enc(1000.0 * rate_bpp / 24.0)

    ref = image.astype(np.float64) / 255.0

    def psnr_of(dec):
        mse = np.mean((dec.astype(np.float64) - ref) ** 2)
        return 10 * np.log10(1.0 / max(mse, 1e-12))

    lo, hi = 1.0, 1000.0
    buf, dec = enc(hi)
    if psnr_of(dec) < psnr_target:  # even (near-)lossless can't reach the target
        return buf, dec
    best = (buf, dec)
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        buf, dec = enc(mid)
        p = psnr_of(dec)
        if abs(p - psnr_target) <= tol:
            return buf, dec
        if p < psnr_target:
            lo = mid
        else:
            hi = mid
            best = (buf, dec)
    return best
