"""
Core differentiable ops on NCHW tensors: convolutions with HWIO kernels,
TF-order depth_to_space, padding, pooling, the clipping straight-through
estimator, the activations, batch normalization to float, the L2 loss, the
NIP's image losses (``LOSSES``), PSNR and the percentile brightness
normalization. Port of the parts of ``neural_imaging_tpu/ops/ops.py`` that
the manipulation-classification path, the camera ISPs and the DCN use.

The reference's exact-f32 conv variants (``small_conv2d``, ``conv_chw``) are
TPU layouts of the same f32 convolution, so here they are a float32
:func:`conv2d`, with TF32 off (``utils.device.resolve_device``).

Precision. The reference names a matrix unit's precision for f32 operands
('highest', 'high', 'default'); a TPU rounds both operands to bfloat16 at
'default' and splits each into two bfloat16 terms at 'high'. The port states
those rounding points itself on every device (:func:`conv2d`,
:func:`matmul`), never through TF32 or a library's heuristics. bfloat16
operands are multiplied exactly and summed in float32, then rounded to
bfloat16 once, on every device (``resolve_device`` turns off cuBLAS's
reduced-precision bf16 reductions). A Python constant in a bfloat16
expression is rounded to bfloat16 first, as jax rounds a weakly typed
constant (:func:`const`).
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F

from neural_imaging_tpu_torch.ops import ssim as ssim_ops
from neural_imaging_tpu_torch.parallel import mesh as mesh_lib


# the reference's matrix-unit precisions of float32 operands
PRECISIONS = ('highest', 'high', 'default')


def hwio_to_oihw(kernel):
    """HWIO kernel (the reference's layout, numpy) → contiguous float32 OIHW tensor."""
    return torch.tensor(kernel, dtype=torch.float32).permute(3, 2, 0, 1).contiguous()


@functools.lru_cache()
def const(value, dtype=torch.float32):
    """A Python constant as jax takes it into an expression of ``dtype`` (a
    weak type): rounded to ``dtype`` first. Returned as a Python float, which
    a bfloat16 expression in torch then uses exactly (torch computes it in
    float32 and rounds the result, as jax does)."""
    return float(torch.tensor(value, dtype=dtype))


@functools.lru_cache()
def scalar(value, dtype, device):
    """``value`` as a 0-d tensor of ``dtype`` on ``device``, made once: a
    divisor that CUDA divides by (it multiplies by the reciprocal of a
    Python scalar), or a bound that keeps ``torch.minimum``'s gradient."""
    return torch.full((), value, dtype=dtype, device=device)


class _RoundBF16(torch.autograd.Function):
    """x rounded to bfloat16 values in x's dtype; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


def round_bf16(x):
    """A float32 operand as a matrix unit at 'default' precision takes it."""
    return _RoundBF16.apply(x)


def _split_bf16(x):
    """(hi, lo) with hi = round_bf16(x) and lo = bf16(x - hi): the two
    bfloat16 terms of 'high' precision. The gradient reaches x through hi."""
    hi = round_bf16(x)
    lo = (x.detach() - hi.detach()).to(torch.bfloat16).to(x.dtype)
    return hi, lo


def at_precision(op, a, b, precision):
    """The bilinear ``op(a, b)`` of float32 operands at a reference precision:
    'highest' (or None) is op itself (float32, TF32 off); 'default' is op of
    the operands rounded to bfloat16, each product then exact and the sum
    float32; 'high' is hi·hi + hi·lo + lo·hi of each operand's two bfloat16
    terms. Other dtypes run op as they are."""
    if precision not in (None,) + PRECISIONS:
        raise ValueError(f'Unsupported precision {precision!r}')
    if precision in (None, 'highest') or a.dtype != torch.float32:
        return op(a, b)
    if precision == 'default':
        return op(round_bf16(a), round_bf16(b))
    a_hi, a_lo = _split_bf16(a)
    b_hi, b_lo = _split_bf16(b)
    return op(a_hi, b_hi) + op(a_hi, b_lo) + op(a_lo, b_hi)


def matmul(a, b, precision=None):
    """``a @ b`` at a reference precision (float32 operands), or of bfloat16
    operands summed in float32 and rounded once (``b`` is cast to a's dtype,
    as the reference casts its constant operators)."""
    return at_precision(torch.matmul, a, b.to(a.dtype), precision)


def _same_pads(size, k, stride):
    """(low, high) zero padding of TF 'SAME' along one axis: the output has
    ceil(size / stride) samples, and an odd total puts the extra pixel at the
    bottom/right (so a 5-tap kernel at stride 2 on an even size pads (1, 2))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, padding='SAME', stride=1, bias=None, precision=None):
    """Conv of NCHW ``x`` with an OIHW ``weight`` tensor (and an optional
    per-channel float32 ``bias``), at a reference ``precision`` for float32
    operands; a bfloat16 ``x`` takes the weight in bfloat16 and sums in
    float32, rounding once.

    ``padding``: 'SAME' (TF semantics at any stride: zero padding, the extra
    pixel at the bottom/right) or 'VALID'."""
    if padding == 'SAME':
        top, bottom = _same_pads(x.shape[-2], weight.shape[-2], stride)
        left, right = _same_pads(x.shape[-1], weight.shape[-1], stride)
        x = F.pad(x, (left, right, top, bottom))
    elif padding != 'VALID':
        raise ValueError(f'Unsupported padding {padding!r}')
    if precision in (None, 'highest'):
        return F.conv2d(x, weight.to(x.dtype), bias, stride)
    y = at_precision(lambda a, b: F.conv2d(a, b, None, stride), x, weight.to(x.dtype),
                      precision)
    return y if bias is None else y + bias[:, None, None]


def small_conv2d(x, weight, padding='SAME'):
    """The reference's exact-f32 conv of tiny kernels: NCHW ``x`` and an OIHW
    ``weight`` (a tensor, or an HWIO numpy kernel) convolved in float32
    whatever x's dtype, the result rounded to x's dtype once. ``padding``:
    'SAME' (the extra pixel of an even kernel at the bottom/right), 'VALID',
    or ((top, bottom), (left, right))."""
    if isinstance(weight, np.ndarray):
        weight = hwio_to_oihw(weight)
    kh, kw = weight.shape[-2:]
    if padding == 'SAME':
        padding = (((kh - 1) // 2, kh - 1 - (kh - 1) // 2),
                   ((kw - 1) // 2, kw - 1 - (kw - 1) // 2))
    xf = x.to(torch.float32)
    if padding != 'VALID':
        (top, bottom), (left, right) = padding
        xf = F.pad(xf, (left, right, top, bottom))
    return F.conv2d(xf, weight.to(device=x.device, dtype=torch.float32)).to(x.dtype)


def depthwise_conv2d(x, k2d, pad_mode='reflect'):
    """Depthwise spatial filter of an NCHW batch, padded 'SAME' with ``pad_mode``.

    ``k2d``: (kh, kw) shared across channels or (kh, kw, C) per channel. As
    in the reference, the kernel and the sums are float32 whatever x's
    dtype, and the result is rounded to x's dtype once."""
    c = x.shape[1]
    k = torch.as_tensor(k2d, dtype=torch.float32, device=x.device)
    if k.ndim == 2:
        k = k[:, :, None].expand(-1, -1, c)
    kh, kw = k.shape[:2]
    if kh != kw:
        raise NotImplementedError('depthwise_conv2d expects a square kernel')
    xp = pad2d(x.to(torch.float32), (kh - 1) // 2, pad_mode)
    return F.conv2d(xp, k.permute(2, 0, 1)[:, None], groups=c).to(x.dtype)


def depth_to_space(x, block=2):
    """TF-order depth_to_space on NCHW: channel (i*block+j)*C + c → subpixel (i, j).

    ``F.pixel_shuffle`` reads channel c*block² + i*block + j instead."""
    n, c, h, w = x.shape
    cc = c // (block * block)
    x = x.reshape(n, block, block, cc, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)                    # (n, cc, h, bi, w, bj)
    return x.reshape(n, cc, h * block, w * block)


def pad2d(x, pad, mode='reflect'):
    """Spatial padding of an NCHW tensor. mode: 'reflect' | 'symmetric' | 'constant'.

    'symmetric' (edge repeated, numpy's mode) has no ``F.pad`` mode and is
    built from flipped edge strips."""
    if pad == 0:
        return x
    if mode in ('reflect', 'constant'):
        return F.pad(x, (pad, pad, pad, pad), mode=mode)
    if mode != 'symmetric':
        raise ValueError(f'Unsupported padding mode {mode!r}')
    x = torch.cat([x[..., :pad, :].flip(-2), x, x[..., -pad:, :].flip(-2)], dim=-2)
    return torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)], dim=-1)


def avg_pool(x, factor):
    """Average pooling with window = stride = factor (NCHW, sizes divisible by
    it). A bfloat16 window is summed in bfloat16, tap by tap in row-major
    order, as jax's ``reduce_window`` sums it."""
    if x.shape[-2] % factor or x.shape[-1] % factor:
        raise ValueError(f'avg_pool: {tuple(x.shape[-2:])} is not divisible by {factor}')
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, factor)
    acc = None
    for dy in range(factor):
        for dx in range(factor):
            tap = x[..., dy::factor, dx::factor]
            acc = tap if acc is None else acc + tap
    return acc / scalar(float(factor * factor), x.dtype, x.device)


@functools.lru_cache()
def _pool_operator(n, factor, dtype, device):
    """(n / factor, n) operator of the mean over each run of ``factor``
    samples (the reference's ``_pool_matrix``) in ``dtype`` on ``device``."""
    m = np.zeros((n // factor, n), np.float32)
    for i in range(n // factor):
        m[i, i * factor:(i + 1) * factor] = 1.0 / factor
    return torch.as_tensor(m, dtype=dtype, device=device)


def avg_pool_flat(x, factor):
    """:func:`avg_pool` as two matrix products, rows then columns (the
    reference's flat-layout pool): float32 at full precision, bfloat16 summed
    in float32 and rounded after each product. :func:`avg_pool` where a side
    does not divide."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        return avg_pool(x, factor)
    rows = matmul(_pool_operator(h, factor, x.dtype, x.device), x)
    return matmul(rows, _pool_operator(w, factor, x.dtype, x.device).T)


def max_pool(x, window=2, padding='VALID'):
    """Max pooling with window = stride (NCHW): 'VALID', or 'SAME', whose
    last window of an odd side takes the samples there are."""
    return F.max_pool2d(x, window, window, ceil_mode=padding == 'SAME')


def global_average_pool(x):
    """Mean over the spatial axes of an NCHW tensor → (N, C)."""
    return x.mean(dim=(-2, -1))


def clip(x, lo, hi):
    """Clip to [lo, hi] with ``jnp.clip``'s gradient: 1 inside, 0 outside and
    1/2 at a bound, where ``torch.clamp`` passes 1 (``torch.maximum`` and
    ``torch.minimum`` split a tie's gradient as jax does). Saturated images
    and probabilities sit exactly at a bound."""
    return torch.minimum(torch.maximum(x, scalar(lo, x.dtype, x.device)),
                         scalar(hi, x.dtype, x.device))


def st_clip(x, lo=0.0, hi=1.0):
    """Clip in the forward pass, identity gradient (the reference's exact form,
    so forward values match it to the bit)."""
    return (torch.clamp(x, lo, hi) - x).detach() + x


def normalize_batch(x):
    """uint8 / uint16 batches → float32 in [0, 1] (÷ 255, ÷ 65535, the same f32
    divide as the reference, by a divisor on x's device: CUDA multiplies by
    the reciprocal of a Python scalar divisor); float batches are cast to
    float32. uint16 is widened through int32, which every device converts."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    if x.dtype == torch.uint16:
        wide = x.view(torch.int16).to(torch.int32) & 0xFFFF
        return wide.to(torch.float32) / torch.full((), 65535.0, device=x.device)
    return x.to(torch.float32)


def l2_loss(x):
    """0.5 * sum(x**2), the DCN objective's ``tf.nn.l2_loss`` convention."""
    return 0.5 * torch.sum(torch.square(x))


def mse(a, b):
    """Mean squared error of two images in [0, 1], on the 0-255 scale."""
    return torch.mean((255.0 * a - 255.0 * b) ** 2)


def mae(a, b):
    """Mean absolute error of two images in [0, 1], on the 0-255 scale."""
    return torch.mean(torch.abs(255.0 * a - 255.0 * b))


def ssim_loss(a, b):
    """255 (1 - SSIM), averaged over the NHWC batches a and b."""
    return torch.mean(255.0 * (1.0 - ssim_ops.ssim(a, b, max_val=1.0)))


def msssim_loss(a, b):
    """255 (1 - MS-SSIM), averaged over the NHWC batches a and b."""
    return torch.mean(255.0 * (1.0 - ssim_ops.ms_ssim(a, b, max_val=1.0)))


# the NIP's fidelity losses by name; each takes (target, output), NHWC
LOSSES = {'L2': mse, 'L1': mae, 'SSIM': ssim_loss, 'MS-SSIM': msssim_loss}


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` with jax's derivative at 0: 1, its x ≥ 0 branch
    (torch's own backward takes the slope there, which moves the gradients
    wherever a pre-activation is exactly 0, as behind a zero bias on a zero
    input)."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, negative_slope=slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def leaky_relu(x, slope=0.2):
    """Leaky ReLU with the reference's slope of 0.2 (torch defaults to 0.01),
    rounded to x's dtype as jax rounds it, and jax's derivative at 0."""
    return _LeakyReLU.apply(x, const(slope, x.dtype))


ACTIVATIONS = {
    'leaky_relu': leaky_relu,
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'softsign': F.softsign,
}


def psnr(a, b, max_val=1.0):
    """PSNR in dB of two batches over all their values (differentiable)."""
    err = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(err, min=1e-12))


def batch_psnr(a, b, max_val=1.0):
    """PSNR in dB of each image of two NHWC batches, shape (N,)."""
    err = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(err, min=1e-12))


def gaussian_kernel_2d(kernlen, std, dtype=torch.float32):
    """(kernlen, kernlen) Gaussian window summing to 1."""
    g1 = torch.exp(-0.5 * ((torch.arange(kernlen, dtype=torch.float32) - (kernlen - 1) / 2.0)
                           / std) ** 2)
    g2 = torch.outer(g1, g1)
    return (g2 / g2.sum()).to(dtype)


def _percentile_of_sorted(values, percentile):
    """``jnp.percentile(x, percentile)`` (linear interpolation) of the
    flattened x sorted ascending, with jax's float32 arithmetic for the
    position: q = percentile / 100, q (n - 1), its floor and ceil and the
    two weights. The gradient reaches the two samples read."""
    n = values.numel()
    q = np.float32(percentile) / np.float32(100)
    pos = q * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_weight = np.float32(pos - low)
    low_weight = np.float32(1) - high_weight
    low, high = int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1))
    return values[low] * float(low_weight) + values[high] * float(high_weight)


def batch_mean(x):
    """``torch.mean(x)``; inside a data-parallel step, the mean over the
    global batch (x being this rank's equal share of it)."""
    mesh = mesh_lib.active()
    if mesh is None:
        return torch.mean(x)
    return mesh_lib.global_sum(torch.sum(x), mesh) / (x.numel() * mesh.world_size)


def percentile_normalize(x, percentile=0.5):
    """Global brightness normalization of ``x`` between its bottom and top
    ``percentile``: x minus its bottom percentile, divided by the top
    percentile of that (at least 1e-9), in the reference's order. One sort
    of all of x serves both percentiles: subtracting a constant keeps the
    order and gives each sorted value minus it, as jax's second sort would.
    (``torch.quantile`` refuses tensors of more than 2^24 values.)

    Inside a data-parallel step (``mesh.batch_reductions``) x is this rank's
    rows and the percentiles are those of the global batch: its values are
    gathered in rank order, the global NHWC order, so that a tie still sends
    the gradient to its first value there."""
    mesh = mesh_lib.active()
    values = x.reshape(-1) if mesh is None else mesh_lib.gather_global(x, mesh)
    bottom, top = percentile_bounds(values, percentile)
    return (x - bottom) / torch.clamp(top, min=1e-9)


def percentile_bounds(values, percentile=0.5):
    """The bottom ``percentile`` of ``values`` and the top percentile of them
    minus it, as :func:`percentile_normalize` takes them (one stable sort)."""
    ordered = torch.sort(values.reshape(-1), stable=True).values
    bottom = _percentile_of_sorted(ordered, percentile)
    return bottom, _percentile_of_sorted(ordered - bottom, 100 - percentile)
