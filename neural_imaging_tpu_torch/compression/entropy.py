"""
Entropy coding for the DCN bitstream: a ``ctypes`` binding to the rANS coder
in ``native/ans/ans.cpp`` (12-bit static frequency model).

The library is built from that source at first use by ``utils/native.py``
(``g++ -O3 -fPIC -shared -std=c++17``, no ``-march=native``) into
``neural_imaging_tpu_torch/_build/``, named by a hash of the source and the
flags. A failed build raises; there is no other coder.

API: ``compress(bytes) -> bytes`` and ``decompress(bytes, n) -> bytes``, with
typed exceptions for the all-identical-symbols and not-compressible cases
that the bitstream handles with its RLE and raw fallbacks.
"""
import ctypes
import functools

from neural_imaging_tpu_torch.models.base import REPO_ROOT
from neural_imaging_tpu_torch.utils import native
from neural_imaging_tpu_torch.utils.native import CXX_FLAGS  # noqa: F401 (the build's flags)

SOURCE = REPO_ROOT / 'native' / 'ans' / 'ans.cpp'


class ANSException(Exception):
    """Base class of entropy-coding errors."""


class ANSSymbolRepetitionError(ANSException):
    """All input bytes are identical: use RLE instead."""


class ANSNotCompressibleError(ANSException):
    """The stream does not compress: store raw bytes instead."""


class ANSCorruptStreamError(ANSException):
    """Malformed stream met while decoding."""


_ERR = {-1: ANSNotCompressibleError, -2: ANSSymbolRepetitionError,
        -3: MemoryError, -4: ANSCorruptStreamError, -5: ValueError}


def library_path():
    """Where the library built from ``native/ans/ans.cpp`` lives."""
    return native.library_path(SOURCE, 'ans')


def build():
    """Compile the coder if its library is missing; returns the library path.
    Raises RuntimeError with the compiler's output if the build fails."""
    return native.build(SOURCE, 'ans')


@functools.lru_cache()
def _library():
    lib = ctypes.CDLL(str(build()))
    buf = ctypes.POINTER(ctypes.c_uint8)
    lib.ans_compress.argtypes = [ctypes.c_char_p, ctypes.c_int, buf, ctypes.c_int]
    lib.ans_compress.restype = ctypes.c_int
    lib.ans_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int, buf, ctypes.c_int]
    lib.ans_decompress.restype = ctypes.c_int
    lib.ans_compress_bound.argtypes = [ctypes.c_int]
    lib.ans_compress_bound.restype = ctypes.c_int
    return lib


def compress(data):
    """Entropy-code a byte string. Raises ANSSymbolRepetitionError or
    ANSNotCompressibleError for degenerate streams (the caller falls back)."""
    data = bytes(data)
    if len(data) == 0:
        raise ValueError('Cannot compress an empty stream')
    lib = _library()
    cap = lib.ans_compress_bound(len(data))
    dst = (ctypes.c_uint8 * cap)()
    rc = lib.ans_compress(data, len(data), dst, cap)
    if rc < 0:
        raise _ERR[rc]('ans_compress failed')
    return ctypes.string_at(dst, rc)


def decompress(data, n=None):
    """Decode an entropy-coded byte string; ``n``, the expected size, is an
    upper bound for the output buffer."""
    data = bytes(data)
    if len(data) < 4:
        raise ANSCorruptStreamError('stream too short')
    cap = max(int.from_bytes(data[:4], 'little'), n or 0)
    dst = (ctypes.c_uint8 * max(cap, 1))()
    rc = _library().ans_decompress(data, len(data), dst, cap)
    if rc < 0:
        raise _ERR[rc]('ans_decompress failed')
    return ctypes.string_at(dst, rc)
