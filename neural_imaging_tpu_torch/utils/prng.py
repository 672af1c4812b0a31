"""
The draws by which the JAX package's flax models are initialized from a
seed, in numpy: ``jax.random``'s default generator (threefry2x32, in the
partitionable layout of its random bits), ``PRNGKey``, ``fold_in``,
``split``, flax's fold-in of a parameter's module path and counter, and
float32 ``uniform`` and ``truncated_normal`` with XLA's single-precision
inverse error function. A layer initialized from ``flax_param_key(key,
path)`` starts from the weights that the JAX package's layer at that path
draws when its flax module is initialized from ``key``, so a run of the port
and one of the reference start from the same model (within an ulp or two
where XLA's float32 arithmetic rounds otherwise).
"""
import hashlib
import math

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 inverse error function (Giles' approximation): the
# polynomials in w = -log1p(-x²) below 5 and in sqrt(w) from 5 up
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# the standard deviation of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def _fma(a, b, c):
    """a * b + c in float32 with one rounding, as XLA's CPU code fuses it."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under ``key``
    (two uint32); returns the two uint32 output arrays."""
    k1, k2 = (np.asarray(k, np.uint32) for k in key)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over='ignore'):
        x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed):
    """``jax.random.PRNGKey(seed)``'s key data for a seed in int32's range."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f'seed {seed} is outside int32')
    return np.array([0, seed & _M32], np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    a, b = threefry2x32(key, [0], [int(data) & _M32])
    return np.array([a[0], b[0]], np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` in the partitionable layout: the
    Threefry hash of a 64-bit iota, its two words the new keys' two words."""
    b1, b2 = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=1)


def fold_in_static(key, parts):
    """flax's fold-in of static data: the first 4 bytes of the SHA-1 of the
    parts (a string's UTF-8, an int's big-endian bytes) as one ``fold_in``."""
    if not parts:
        return key
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode('utf-8'))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder='big'))
        else:
            raise ValueError(f'Expected int or string, got: {x}')
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder='big'))


def flax_param_key(key, path, counter=1):
    """The key flax's ``init(key, ...)`` gives the ``counter``-th parameter
    drawn in the module at ``path`` (a name or a tuple of names from the
    root): a conv's or dense layer's kernel is its first."""
    path = (path,) if isinstance(path, str) else tuple(path)
    return fold_in_static(key, (*path, counter))


def random_bits32(key, n):
    """``n`` uint32 random bits of ``key``, as ``jax.random.bits`` lays them
    out with ``jax_threefry_partitionable`` (a 64-bit iota, hashed, the two
    words xor-ed)."""
    if n >= 2 ** 32:
        raise ValueError('more than 2**32 values')
    b1, b2 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 ``jax.random.uniform``: 23 random mantissa bits in [1, 2),
    shifted and scaled to [minval, maxval)."""
    bits = random_bits32(key, math.prod(shape))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo)).reshape(shape)


def erfinv32(x):
    """XLA's float32 inverse error function, evaluated in float32."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide='ignore', invalid='ignore'):       # at |x| = 1
        w = -np.log1p(-x * x)
        small = w < np.float32(5)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
        p = np.where(small, np.float32(_ERFINV_W_LT_5[0]), np.float32(_ERFINV_W_GE_5[0]))
        for lt, ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
            p = _fma(p, w, np.where(small, np.float32(lt), np.float32(ge)))
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def truncated_normal(key, lower, upper, shape):
    """float32 ``jax.random.truncated_normal``: the inverse error function of
    a uniform draw between erf(lower/√2) and erf(upper/√2), times √2, clipped
    to the open interval."""
    sqrt2 = np.float32(np.sqrt(2))
    lower, upper = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lower / sqrt2)))
    b = np.float32(math.erf(float(upper / sqrt2)))
    out = sqrt2 * erfinv32(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf))).astype(np.float32)


def lecun_normal(key, shape):
    """flax's default kernel init (``lecun_normal``) of a kernel in flax's
    layout (the input features second to last, the output's last): a
    standard normal truncated to (-2, 2), scaled to variance 1/fan_in, in
    float32."""
    variance = np.float32(1.0 / math.prod(shape[:-1]))
    stddev = np.sqrt(variance) / np.float32(TRUNCATED_STD)
    return (truncated_normal(key, -2, 2, shape) * stddev).astype(np.float32)
