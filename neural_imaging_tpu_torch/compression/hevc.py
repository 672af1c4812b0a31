"""
In-process HEVC-intra still-image codec over the system libx265 (encode) and
libde265 (decode), via ctypes: no binaries, no Python bindings. Port of
``neural_imaging_tpu/compression/hevc.py``, a copy of its code.

BPG is HEVC intra plus a ~20-byte container (the bpgenc pipeline: RGB →
YCbCr → x265 CQP intra encode → strip NAL framing into the BPG header), and
these are the codec libraries bpgenc builds on, so this module makes the
measurement that matters (HEVC intra payload bytes against reconstruction
fidelity at a given QP) in-process:

    encode_rgb(image, qp)  -> Annex-B HEVC intra payload (bytes)
    decode_rgb(payload)    -> float RGB in [0,1]

As in the JAX package, ``bpg_helpers`` does not use it: the BPG leg of the
rate-distortion sweep needs the bpgenc/bpgdec binaries.

ABI safety: x265's public structs are version-dependent, so nothing here
hardcodes blind offsets. The library reports X265_BUILD via x265_api_get and
`sizeof(x265_picture)`; the picture field offsets (planes/stride/bitDepth/
colorSpace) are *calibrated at load time* by probing what x265_picture_init
writes (bitDepth at +60, colorSpace at +72 for build 199) and the loader
refuses to run if the probe does not match. libde265's API is pure opaque
pointers + accessor functions — no struct knowledge needed at all.
"""
import ctypes as ct
import ctypes.util
import threading

import numpy as np

__all__ = ['available', 'versions', 'encode_rgb', 'decode_rgb', 'encode_i420',
           'decode_i420', 'HEVCError']


class HEVCError(RuntimeError):
    pass


# ----------------------------------------------------------------- x265 (encode)

# x265_picture offsets for X265_BUILD 199 (x265 3.5): int64 pts, int64 dts,
# void* userData, void* planes[3], int stride[3], int bitDepth, int sliceType,
# int poc, int colorSpace, ... — verified by the load-time calibration probe.
_PIC_PLANES_OFF = 24
_PIC_STRIDE_OFF = 48
_PIC_BITDEPTH_OFF = 60
_PIC_COLORSPACE_OFF = 72


class _X265Nal(ct.Structure):
    # stable across every x265 release: { uint32 type; uint32 sizeBytes;
    # uint8_t* payload; } (+alignment padding)
    _fields_ = [('type', ct.c_uint32), ('sizeBytes', ct.c_uint32),
                ('payload', ct.POINTER(ct.c_ubyte))]


class _X265:
    """Lazily-loaded, calibrated libx265 handle (singleton)."""

    def __init__(self):
        name = ctypes.util.find_library('x265') or 'libx265.so.199'
        try:
            lib = ct.CDLL(name)
        except OSError as e:
            raise HEVCError(f'libx265 not loadable: {e}')
        lib.x265_param_alloc.restype = ct.c_void_p
        lib.x265_param_free.argtypes = [ct.c_void_p]
        lib.x265_param_default_preset.argtypes = [ct.c_void_p, ct.c_char_p,
                                                  ct.c_char_p]
        lib.x265_param_parse.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_char_p]
        lib.x265_picture_alloc.restype = ct.c_void_p
        lib.x265_picture_free.argtypes = [ct.c_void_p]
        lib.x265_picture_init.argtypes = [ct.c_void_p, ct.c_void_p]
        self._open = getattr(lib, 'x265_encoder_open_199', None)
        if self._open is None:  # a different build number than this probe knows
            raise HEVCError('x265_encoder_open_199 not exported '
                            '(unexpected libx265 build)')
        self._open.restype = ct.c_void_p
        self._open.argtypes = [ct.c_void_p]
        lib.x265_encoder_encode.restype = ct.c_int
        lib.x265_encoder_encode.argtypes = [
            ct.c_void_p, ct.POINTER(ct.POINTER(_X265Nal)),
            ct.POINTER(ct.c_uint32), ct.c_void_p, ct.c_void_p]
        lib.x265_encoder_close.argtypes = [ct.c_void_p]
        # x265_api begins { int major; int build; int sizeof_param;
        # int sizeof_picture; ... } in every 2.x/3.x release
        api_get = getattr(lib, 'x265_api_get_199')
        api_get.restype = ct.POINTER(ct.c_int)
        api = api_get(0)
        self.build = api[1]
        self.sizeof_picture = api[3]
        self.lib = lib
        self._calibrate()

    def _calibrate(self):
        """Verify the x265_picture field offsets against what picture_init
        actually writes (bitDepth=8 and colorSpace=I420=1 on a default param)."""
        lib = self.lib
        param = lib.x265_param_alloc()
        if not param or lib.x265_param_default_preset(param, b'medium', None) != 0:
            raise HEVCError('x265 param initialization failed')
        pic = lib.x265_picture_alloc()
        ct.memset(pic, 0, self.sizeof_picture)
        lib.x265_picture_init(param, pic)
        raw = bytes((ct.c_ubyte * self.sizeof_picture).from_address(pic))
        bit_depth = int.from_bytes(raw[_PIC_BITDEPTH_OFF:_PIC_BITDEPTH_OFF + 4],
                                   'little')
        csp = int.from_bytes(raw[_PIC_COLORSPACE_OFF:_PIC_COLORSPACE_OFF + 4],
                             'little')
        lib.x265_picture_free(pic)
        lib.x265_param_free(param)
        if bit_depth != 8 or csp != 1:  # X265_CSP_I420 == 1
            raise HEVCError(
                f'x265_picture layout mismatch (build {self.build}: probe found '
                f'bitDepth={bit_depth}@+{_PIC_BITDEPTH_OFF}, '
                f'colorSpace={csp}@+{_PIC_COLORSPACE_OFF}) — refusing to encode '
                f'with unverified struct offsets')


class _De265:
    """Lazily-loaded libde265 handle (opaque-pointer API — no structs)."""

    def __init__(self):
        name = ctypes.util.find_library('de265') or 'libde265.so.0'
        try:
            lib = ct.CDLL(name)
        except OSError as e:
            raise HEVCError(f'libde265 not loadable: {e}')
        lib.de265_new_decoder.restype = ct.c_void_p
        lib.de265_push_data.restype = ct.c_int
        lib.de265_push_data.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                        ct.c_int64, ct.c_void_p]
        lib.de265_flush_data.argtypes = [ct.c_void_p]
        lib.de265_decode.restype = ct.c_int
        lib.de265_decode.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int)]
        lib.de265_get_next_picture.restype = ct.c_void_p
        lib.de265_get_next_picture.argtypes = [ct.c_void_p]
        lib.de265_get_image_width.restype = ct.c_int
        lib.de265_get_image_width.argtypes = [ct.c_void_p, ct.c_int]
        lib.de265_get_image_height.restype = ct.c_int
        lib.de265_get_image_height.argtypes = [ct.c_void_p, ct.c_int]
        lib.de265_get_image_plane.restype = ct.POINTER(ct.c_ubyte)
        lib.de265_get_image_plane.argtypes = [ct.c_void_p, ct.c_int,
                                              ct.POINTER(ct.c_int)]
        lib.de265_free_decoder.argtypes = [ct.c_void_p]
        if hasattr(lib, 'de265_disable_logging'):
            lib.de265_disable_logging()
        self.lib = lib


_lock = threading.Lock()
_x265 = None
_de265 = None
_unavailable = None


def _handles():
    global _x265, _de265, _unavailable
    with _lock:
        if _unavailable is not None:
            raise HEVCError(_unavailable)
        if _x265 is None:
            try:
                _x265 = _X265()
                _de265 = _De265()
            except HEVCError as e:
                _unavailable = str(e)
                _x265 = None
                raise
        return _x265, _de265


def available():
    """True when both libx265 and libde265 load and pass layout calibration."""
    try:
        _handles()
        return True
    except HEVCError:
        return False


def versions():
    """{'x265': its version and build, 'de265': its version}; raises
    HEVCError when either does not load."""
    x, d = _handles()
    x265 = ct.c_char_p.in_dll(x.lib, 'x265_version_str').value.decode()
    d.lib.de265_get_version.restype = ct.c_char_p
    return {'x265': f'{x265} (build {x.build})', 'de265': d.lib.de265_get_version().decode()}


# ------------------------------------------------------------- color / sampling

# BT.601 full-range ("JPEG style") — matches BPG's default color space 0
_FWD = np.array([[0.299, 0.587, 0.114],
                 [-0.168736, -0.331264, 0.5],
                 [0.5, -0.418688, -0.081312]], dtype=np.float64)


def _rgb_to_i420(image):
    """float/uint8 RGB (H, W, 3) → (y, cb, cr) uint8 planes, chroma 2×2 box."""
    rgb = np.asarray(image)
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:  # HEVC 4:2:0 needs even dims; edge-pad like bpgenc
        rgb = np.pad(rgb, ((0, h % 2), (0, w % 2), (0, 0)), mode='edge')
    ycc = rgb.astype(np.float64) @ _FWD.T
    y = np.clip(ycc[..., 0].round(), 0, 255).astype(np.uint8)
    cb = ycc[..., 1] + 128.0
    cr = ycc[..., 2] + 128.0
    # 2x2 box-average subsampling
    def pool(c):
        c = c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean(axis=(1, 3))
        return np.clip(c.round(), 0, 255).astype(np.uint8)
    return y, pool(cb), pool(cr), h, w


def _i420_to_rgb(y, cb, cr, h, w):
    """uint8 planes → float RGB [0,1]; bilinear chroma upsampling."""
    def up(c):
        c = c.astype(np.float64)
        # co-sited bilinear 2x upsample (average of the 4 nearest chroma sites)
        c = np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
        k = np.array([0.25, 0.5, 0.25])
        c = np.apply_along_axis(lambda r: np.convolve(np.pad(r, 1, 'edge'), k,
                                                      'valid'), 0, c)
        c = np.apply_along_axis(lambda r: np.convolve(np.pad(r, 1, 'edge'), k,
                                                      'valid'), 1, c)
        return c
    yf = y.astype(np.float64)
    cbf = up(cb) - 128.0
    crf = up(cr) - 128.0
    inv = np.linalg.inv(_FWD)
    rgb = np.stack([yf, cbf, crf], axis=-1) @ inv.T
    rgb = rgb[:h, :w]
    return np.clip(rgb / 255.0, 0.0, 1.0).astype(np.float32)


# ------------------------------------------------------------------ encode path

def encode_i420(y, cb, cr, qp=28, preset='medium'):
    """Encode uint8 I420 planes as one HEVC intra frame at constant QP.

    Returns the Annex-B bitstream (VPS/SPS/PPS + IDR slice, start-coded) —
    the same payload bpgenc re-packs into the BPG container.
    """
    x = _handles()[0]
    lib = x.lib
    h, w = y.shape
    assert cb.shape == (h // 2, w // 2) and cr.shape == cb.shape

    param = lib.x265_param_alloc()
    if not param:
        raise HEVCError('x265_param_alloc failed')
    enc = None
    pic = None
    try:
        if lib.x265_param_default_preset(param, preset.encode(), None) != 0:
            raise HEVCError(f'unknown x265 preset {preset!r}')
        settings = {
            'input-res': f'{w}x{h}', 'fps': '25', 'input-csp': 'i420',
            'qp': str(int(qp)),            # CQP — what bpgenc -q maps to
            'keyint': '1',                 # one intra frame (x265 has no 'frames' parameter)
            'info': '0',                   # no options-SEI (~600 B of overhead)
            'temporal-layers': '0', 'log-level': 'none',
            'range': 'full',               # BPG default is full-range YCbCr
        }
        for k, v in settings.items():
            if lib.x265_param_parse(param, k.encode(), v.encode()) != 0:
                raise HEVCError(f'x265_param_parse({k}={v}) failed')
        enc = x._open(param)
        if not enc:
            raise HEVCError('x265_encoder_open failed')

        pic = lib.x265_picture_alloc()
        ct.memset(pic, 0, x.sizeof_picture)
        lib.x265_picture_init(param, pic)

        planes = [np.ascontiguousarray(p) for p in (y, cb, cr)]
        addr_arr = (ct.c_void_p * 3).from_address(pic + _PIC_PLANES_OFF)
        stride_arr = (ct.c_int * 3).from_address(pic + _PIC_STRIDE_OFF)
        for i, p in enumerate(planes):
            addr_arr[i] = p.ctypes.data
            stride_arr[i] = p.strides[0]

        nals = ct.POINTER(_X265Nal)()
        n_nal = ct.c_uint32(0)
        out = bytearray()

        def collect(ret):
            if ret < 0:
                raise HEVCError('x265_encoder_encode failed')
            for i in range(n_nal.value):
                nal = nals[i]
                out.extend(ct.string_at(nal.payload, nal.sizeBytes))
            return ret

        collect(lib.x265_encoder_encode(enc, ct.byref(nals), ct.byref(n_nal),
                                        pic, None))
        while collect(lib.x265_encoder_encode(enc, ct.byref(nals),
                                              ct.byref(n_nal), None, None)) > 0:
            pass
        if not out:
            raise HEVCError('x265 produced no output')
        return bytes(out)
    finally:
        if pic:
            lib.x265_picture_free(pic)
        if enc:
            lib.x265_encoder_close(enc)
        lib.x265_param_free(param)


def decode_i420(payload):
    """Decode an Annex-B HEVC bitstream; returns (y, cb, cr) uint8 planes."""
    d = _handles()[1]
    lib = d.lib
    ctx = lib.de265_new_decoder()
    if not ctx:
        raise HEVCError('de265_new_decoder failed')
    try:
        buf = np.frombuffer(payload, dtype=np.uint8)
        err = lib.de265_push_data(ctx, buf.ctypes.data, len(payload), 0, None)
        if err != 0:
            raise HEVCError(f'de265_push_data error {err}')
        lib.de265_flush_data(ctx)
        img = None
        more = ct.c_int(1)
        for _ in range(10000):
            img = lib.de265_get_next_picture(ctx)
            if img:
                break
            if not more.value:
                break
            lib.de265_decode(ctx, ct.byref(more))
        if not img:
            raise HEVCError('de265 produced no picture')
        planes = []
        for ch in range(3):
            w = lib.de265_get_image_width(img, ch)
            h = lib.de265_get_image_height(img, ch)
            stride = ct.c_int(0)
            ptr = lib.de265_get_image_plane(img, ch, ct.byref(stride))
            if not ptr:
                raise HEVCError(f'de265 plane {ch} missing')
            rows = np.ctypeslib.as_array(ptr, shape=(h, stride.value))
            planes.append(rows[:, :w].copy())
        return planes[0], planes[1], planes[2]
    finally:
        lib.de265_free_decoder(ctx)


def encode_rgb(image, qp=28, preset='medium'):
    """RGB (float [0,1] or uint8) → HEVC intra payload bytes at constant QP."""
    y, cb, cr, _, _ = _rgb_to_i420(image)
    return encode_i420(y, cb, cr, qp=qp, preset=preset)


def decode_rgb(payload, height=None, width=None):
    """HEVC intra payload → float RGB in [0,1]. Pass the original (pre-pad)
    height/width to crop odd-sized images back (encode pads to even dims)."""
    y, cb, cr = decode_i420(payload)
    h = height if height is not None else y.shape[0]
    w = width if width is not None else y.shape[1]
    return _i420_to_rgb(y, cb, cr, h, w)
