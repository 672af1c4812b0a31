"""
K1, the fused differentiable-JPEG core: per 8x8 block of each centered
YCbCr plane, DCT → divide by the plane's q-table → round half to even →
multiply back → inverse DCT.

- :func:`jpeg_core_cuda` launches the hand-written CUDA kernel
  (``csrc/jpeg8x8.cu``, built for sm_90a by ``_build``). It replaces the TPU
  kernel ``neural_imaging_tpu/ops/pallas/jpeg8x8.py::_strip_kernel``.
- :func:`jpeg_core_plain` is the same math in plain PyTorch (blockify →
  dct2d → round → idct2d). The CPU takes it; the GPU checks compare the
  kernel with it.
- :func:`jpeg_core` dispatches on the tensor's device (CPU → plain, CUDA →
  kernel, through the registered operator
  ``torch.ops.neural_imaging_tpu_torch.jpeg8x8``, nothing else) and is
  differentiable: its backward mirrors the reference's XLA VJP ``_bwd`` (the
  soft-rounding derivative 1 − cos 2πu), in plain PyTorch, as the
  reference's backward is not a kernel either.
- :func:`jpeg_core_work` is one launch's work, which bounds the kernel.
"""
import ctypes
import functools
import math

import torch

from neural_imaging_tpu_torch.ops import dct as dct_ops
from neural_imaging_tpu_torch.ops.hopper import registry

LIBRARY = 'jpeg8x8'
# per pixel: 4 passes of 8-term dot products (8 FMA = 16 FLOP each) plus the
# divide, round and multiply
K1_FLOP_PER_PIXEL = 4 * 16 + 3


@functools.lru_cache()
def _launcher():
    from neural_imaging_tpu_torch.ops.hopper import _build
    fn = _build.load(LIBRARY).jpeg8x8_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(planes, q_tables):
    if planes.dtype != torch.float32 or q_tables.dtype != torch.float32:
        raise TypeError(f'jpeg core takes float32, got {planes.dtype} and {q_tables.dtype}')
    if planes.ndim != 3:
        raise ValueError(f'planes must be (P, H, W), got {tuple(planes.shape)}')
    p, h, w = planes.shape
    if p == 0 or h == 0 or w == 0 or h % 8 or w % 8:
        raise ValueError(f'planes {tuple(planes.shape)}: H and W must be positive '
                         'multiples of 8')
    if tuple(q_tables.shape) != (p, 8, 8):
        raise ValueError(f'q_tables must be ({p}, 8, 8), got {tuple(q_tables.shape)}')


def jpeg_core_cuda(planes, q_tables):
    """Launch K1 on CUDA tensors: planes (P, H, W) and q_tables (P, 8, 8), both
    float32 and contiguous on one device. Returns (reconstruction,
    dequantized coefficients), each (P, H, W); the coefficient of block
    (i, j) at frequency (k, l) sits at [8i + k, 8j + l]."""
    _check(planes, q_tables)
    if planes.device.type != 'cuda' or q_tables.device != planes.device:
        raise ValueError(f'jpeg_core_cuda needs both inputs on one CUDA device, got '
                         f'{planes.device} and {q_tables.device}')
    if not (planes.is_contiguous() and q_tables.is_contiguous()):
        raise ValueError('jpeg_core_cuda needs contiguous inputs')
    p, h, w = planes.shape
    if p > 65535 or h // 8 > 65535:
        raise ValueError(f'planes {tuple(planes.shape)} exceed the launch grid')
    d = dct_ops.dct_tensor(planes.device)
    y = torch.empty_like(planes)
    c = torch.empty_like(planes)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = _launcher()(planes.data_ptr(), q_tables.data_ptr(), d.data_ptr(),
                      y.data_ptr(), c.data_ptr(), p, h, w, planes.device.index or 0,
                      stream)
    if err != 0:
        raise RuntimeError(f'jpeg8x8 kernel launch failed with CUDA error {err}')
    jpeg_core_cuda.launches += 1
    return y, c


jpeg_core_cuda.launches = 0


def jpeg_core_work(planes_shape, q_tables_shape=None):
    """(FLOPs, bytes) of one launch on planes of shape (P, H, W): the
    transform's arithmetic, and the planes read once, y and c written once,
    the P q-tables and the DCT matrix read once (float32)."""
    p, h, w = planes_shape
    pixels = p * h * w
    return K1_FLOP_PER_PIXEL * pixels, 4 * (3 * pixels + 64 * p + 64)


def _launch(planes: torch.Tensor, q_tables: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return jpeg_core_cuda(planes, q_tables)


def _fake(planes, q_tables):
    _check(planes, q_tables)
    return torch.empty_like(planes), torch.empty_like(planes)


jpeg8x8_op = registry.register(LIBRARY, _launch, _fake, jpeg_core_work)


def jpeg_core_plain(planes, q_tables):
    """K1's math in plain PyTorch; same arguments and results as
    :func:`jpeg_core_cuda`, on any device."""
    _check(planes, q_tables)
    q = q_tables[:, None, None]
    xq = torch.round(dct_ops.dct2d(dct_ops.blockify(planes)) / q) * q
    return dct_ops.deblockify(dct_ops.idct2d(xq)), dct_ops.deblockify(xq)


def jpeg_core_backward(planes, q_tables, g_y, g_c):
    """VJP of the core for the soft-rounding STE: rematerializes u = DCT(x)/q
    and uses d round/du ≈ 1 − cos 2πu. Returns (d planes, d q_tables)."""
    q = q_tables[:, None, None]
    u = dct_ops.dct2d(dct_ops.blockify(planes)) / q
    du = 1.0 - torch.cos(2.0 * math.pi * u)
    # cotangent of the dequantized coefficients: through y (the IDCT's
    # adjoint is the DCT) plus the direct one
    g_xq = dct_ops.dct2d(dct_ops.blockify(g_y)) + dct_ops.blockify(g_c)
    g_planes = dct_ops.deblockify(dct_ops.idct2d(g_xq * du))
    # Xq = q r(X/q)  →  dXq/dq = r(u) − u r'(u)
    r_u = u - torch.sin(2.0 * math.pi * u) / (2.0 * math.pi)
    g_q = (g_xq * (r_u - u * du)).sum(dim=(1, 2))
    return g_planes, g_q


class _JpegCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, q_tables):
        ctx.save_for_backward(planes, q_tables)
        if planes.device.type == 'cpu':
            return jpeg_core_plain(planes, q_tables)
        return jpeg8x8_op(planes, q_tables)

    @staticmethod
    def backward(ctx, g_y, g_c):
        planes, q_tables = ctx.saved_tensors
        return jpeg_core_backward(planes, q_tables, g_y, g_c)


def jpeg_core(planes, q_tables):
    """Differentiable fused JPEG core (see module docstring for the dispatch)."""
    return _JpegCore.apply(planes, q_tables)


# Agreement of two float32 implementations of the core on the same inputs
# (the kernel and its plain version, or the port and the JAX reference):
# at most 1 in 1000 coefficients flipped, and the 255-scaled reconstruction
# within 1e-4 in every block without a flip.
MAX_FLIP_SHARE = 1e-3
MAX_ABS_ERR = 1e-4


def check_cores(y_a, c_a, y_b, c_b, q_tables):
    """Hold two results of the core on the same inputs against each other.

    A last-bit difference before rounding can move a coefficient by one full
    q step (a flip), which changes its whole 8x8 block of the
    reconstruction. So this counts flipped coefficients and takes the max
    |Δy| only over blocks without a flip, and raises AssertionError beyond
    ``MAX_FLIP_SHARE`` or ``MAX_ABS_ERR``. Returns a dict with ``flipped``,
    ``coefficients``, ``max_abs_err`` (unflipped blocks) and
    ``max_abs_err_all``."""
    q = q_tables[:, None, None]
    flips = (dct_ops.blockify(c_a) - dct_ops.blockify(c_b)).abs() > 0.5 * q
    clean = ~flips.any(dim=-1).any(dim=-1)                 # (P, H/8, W/8)
    dy = (dct_ops.blockify(y_a) - dct_ops.blockify(y_b)).abs().amax(dim=(-2, -1))
    report = {
        'flipped': int(flips.sum()),
        'coefficients': flips.numel(),
        'max_abs_err': float(dy[clean].max()) if bool(clean.any()) else float('nan'),
        'max_abs_err_all': float(dy.max()),
    }
    if (report['flipped'] > MAX_FLIP_SHARE * report['coefficients']
            or not report['max_abs_err'] <= MAX_ABS_ERR):
        raise AssertionError(f'jpeg core results disagree: {report}')
    return report
