"""
K1, the fused differentiable-JPEG core: per 8x8 block of each centered
YCbCr plane, DCT → divide by the plane's q-table → round half to even →
multiply back → inverse DCT.

- :func:`jpeg_core_cuda` launches the hand-written CUDA kernel
  (``csrc/jpeg8x8.cu``, built for sm_90a by ``_build``) with the geometry of
  :func:`launch_plan`, and tallies its launches (``launches``) and their
  shapes (``sizes``). It replaces the TPU kernel
  ``neural_imaging_tpu/ops/pallas/jpeg8x8.py::_strip_kernel``.
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
import collections
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache()
def _residency(device_index):
    """{'sms': the card's SMs, 'resident_warps': the warps of K1 an SM keeps
    resident at ``MAX_BLOCK`` threads a block} on CUDA device
    ``device_index``, from the CUDA runtime's occupancy of the built kernel."""
    from neural_imaging_tpu_torch.ops.hopper import _build
    fn = _build.load(LIBRARY).jpeg8x8_residency
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    sms, warps = ctypes.c_int(), ctypes.c_int()
    err = fn(device_index, MAX_BLOCK, ctypes.byref(sms), ctypes.byref(warps))
    if err != 0 or warps.value < 1:
        raise RuntimeError(f'jpeg8x8 occupancy query failed with CUDA error {err}')
    return {'sms': sms.value, 'resident_warps': warps.value}


# The launch geometry (``csrc/jpeg8x8.cu``): a warp takes 4 neighbouring 8x8
# tiles ("a group") at a time, 8 lanes a tile, and warps walk the groups at a
# stride of the grid's warps. On the card the SMs and the resident warps come
# from ``_residency``; these defaults are the H100's and the kernel's there.
SMS = 132                       # H100 SXM
RESIDENT_WARPS = 40
TILES_PER_WARP = 4
# A warp's ring keeps its next groups in flight, yet one wave of warps that
# each walk many groups ran slower than more waves of warps that walk few
# (the D90's whole image: 0.178-0.185 ms at 27-34 groups a warp, 0.157-0.160
# at 1-2; NVIDIA H100 80GB HBM3, bench_jpeg8x8.py --plans): a warp takes up
# to 3 groups where that fills one wave, else at most 2. Blocks of 128
# threads ran 0-3% faster than of 256 (bench_jpeg8x8.py against a tree
# that differs in that alone); the kernel takes up to 256
MAX_GROUPS_PER_WARP = 2
ONE_WAVE_GROUPS = 3
MAX_BLOCK = 128
MIN_BLOCK = 32
MAX_TILES = 2 ** 31             # the kernel's 32-bit tile index


def launch_plan(p, h, w, sms=SMS, resident_warps=RESIDENT_WARPS):
    """(grid, block) of K1's launch on planes (P, H, W).

    A launch of more groups of 4 tiles than the card holds warps (``sms`` x
    ``resident_warps``) fills every resident slot where no warp then takes
    more than ``ONE_WAVE_GROUPS``, else launches enough warps for
    ``MAX_GROUPS_PER_WARP`` each, in blocks of 128 threads; the warps'
    shares differ by at most one group. A smaller one gives each warp one
    group, in blocks of 128 threads, halved (down to a warp) until there are
    at least two blocks an SM, so that every SM takes a share."""
    tiles = p * (h // 8) * (w // 8)
    if tiles >= MAX_TILES:
        raise ValueError(f'planes {(p, h, w)} exceed the kernel\'s {MAX_TILES} tiles')
    groups = -(-tiles // TILES_PER_WARP)
    resident = sms * resident_warps
    if groups > resident:
        warps = (resident if groups <= ONE_WAVE_GROUPS * resident
                 else max(resident, -(-groups // MAX_GROUPS_PER_WARP)))
        return -(-warps * 32 // MAX_BLOCK), MAX_BLOCK
    block = MAX_BLOCK
    while block > MIN_BLOCK and -(-groups * 32 // block) < 2 * sms:
        block //= 2
    return -(-groups * 32 // block), block


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
    grid, block = launch_plan(p, h, w, **_residency(planes.device.index or 0))
    # 16-byte accesses: a contiguous view may start anywhere in its storage
    planes, q_tables = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (planes, q_tables))
    y = torch.empty_like(planes)
    c = torch.empty_like(planes)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = _launcher()(planes.data_ptr(), q_tables.data_ptr(), _DCT.ctypes.data,
                      y.data_ptr(), c.data_ptr(), p, h, w, grid, block,
                      planes.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f'jpeg8x8 kernel launch failed with CUDA error {err}')
    jpeg_core_cuda.launches += 1
    jpeg_core_cuda.sizes[(p, h, w)] += 1
    return y, c


jpeg_core_cuda.launches = 0
jpeg_core_cuda.sizes = collections.Counter()     # launches by (P, H, W)
# the DCT matrix, handed to the launcher, which holds it against its own
_DCT = dct_ops.dct_matrix()


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
