"""
Differentiable image manipulations that the forensic workflow learns to
classify, on NCHW batches in [0,1]. Port of
``neural_imaging_tpu/ops/manipulations.py``: sharpen, resample, gaussian,
jpeg, awgn, gamma and median at a fixed strength (``MANIPULATIONS``) and
with the strength in a 0-d tensor on the batch's device
(``TRACED_MANIPULATIONS``, ``resample_switch``, ``median_switch``), so
that a training step draws its strengths on the device and never waits on
the host for them. awgn takes its noise, or a ``torch.Generator`` to draw it
from, and never the global one.

The exact fused manipulate-then-pool branches (``POOLED_MANIPULATIONS``,
the workflow's ``_manipulate(pool=True)``) and the high-pass ``residual``
are ported for parity with the reference only: no entry point of either
package uses them.

A bfloat16 batch (a bfloat16 channel) stays bfloat16 where the reference's
does: filters are built and summed in float32 and each filtered result is
rounded once; each resize product is summed in float32 and rounded; the
fixed-quality jpeg runs in float32, as the reference's codec casts its input;
a strength in a 0-d float32 tensor promotes awgn and gamma to float32, as a
jax array does; a Python strength is rounded to the batch's dtype first.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from neural_imaging_tpu_torch.models.jpeg import jpeg_forward_nchw, jpeg_qtable_traced, qtables
from neural_imaging_tpu_torch.ops import color, ops, quantization
from neural_imaging_tpu_torch.ops.kernels import gkern, repeat_2dfilter


@functools.lru_cache()
def _resize_matrix(n_in, n_out):
    """(n_out, n_in) float32 operator of ``jax.image.resize``'s 1-D 'bilinear'
    resize: half-pixel centers, triangle kernel widened by the scale when
    downsampling (antialiasing), weights normalized per output sample.

    ``F.interpolate`` does not antialias and is a different operator. This
    repeats jax's ``compute_weight_mat`` step by step in float32, from the
    scale that jax forms in double: an ulp of 1/scale would move the last
    sample by ~n_out ulps."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


@functools.lru_cache()
def _resize_operator(n_in, n_out, dtype, device):
    """:func:`_resize_matrix` on ``device``, copied there once (a copy from the
    host waits for the device's queue)."""
    return torch.as_tensor(_resize_matrix(n_in, n_out), dtype=dtype, device=device)


def resize_bilinear(x, h_out, w_out):
    """``jax.image.resize(..., 'bilinear')`` of an NCHW batch as two matrix
    products (rows, then columns; the reference's ``resize_bilinear_flat``),
    the operators in x's dtype, each product summed in float32 and rounded
    to x's dtype."""
    h, w = x.shape[-2:]
    if h_out != h:
        x = ops.matmul(_resize_operator(h, h_out, x.dtype, x.device), x)
    if w_out != w:
        x = ops.matmul(x, _resize_operator(w, w_out, x.dtype, x.device).T)
    return x


def _resample_size(side, factor):
    if 0 < factor <= 1:
        factor = 100 * factor
    return side * int(factor) // 100


def resample(x, factor=50):
    """Bilinear down-and-back-up resampling by a percentage factor (50 → half
    size). Like the reference's, the result is square, of the input's height."""
    side = x.shape[-2]
    size = _resample_size(side, factor)
    return resize_bilinear(resize_bilinear(x, size, size), side, side)


@functools.lru_cache()
def _resample_operators(n_in, n_out, candidates, device):
    """(K, n_out, n_in) float32 operators of ``resample`` along one axis, one
    per candidate factor: the up-resize times the down-resize, formed in
    float64 and rounded once."""
    ops_k = []
    for factor in candidates:
        size = _resample_size(n_out, factor)
        up = _resize_matrix(size, n_out).astype(np.float64)
        down = _resize_matrix(n_in, size).astype(np.float64)
        ops_k.append(up @ down)
    return torch.as_tensor(np.stack(ops_k).astype(np.float32), device=device)


@functools.lru_cache()
def _resample_stages(n_in, side, candidates, dtype, device):
    """(down (K, m, n_in), up (K, side, m)) in ``dtype``: each candidate
    factor's resize operators along one axis (to the size :func:`resample`
    takes from ``side``, and back to ``side``), zero-padded to the largest
    intermediate size m. The padding adds exact zeros to every sum."""
    sizes = [_resample_size(side, f) for f in candidates]
    m = max(sizes)
    down = np.zeros((len(candidates), m, n_in), np.float32)
    up = np.zeros((len(candidates), side, m), np.float32)
    for k, size in enumerate(sizes):
        down[k, :size] = _resize_matrix(n_in, size)
        up[k, :, :size] = _resize_matrix(size, side)
    return (torch.as_tensor(down, dtype=dtype, device=device),
            torch.as_tensor(up, dtype=dtype, device=device))


def resample_switch(x, index, candidates):
    """``resample(x, candidates[index])`` with the index in a 0-d integer
    tensor on x's device (or an int), picked on the device, so no
    candidate's own intermediate shape needs the index on the host.

    float32: each candidate's down-and-up resize is one operator per axis,
    equal to :func:`resample` up to float32 rounding. Other dtypes (bfloat16)
    round after each of the four products, as :func:`resample` does, through
    operators zero-padded to one shape (``_resample_stages``)."""
    side = x.shape[-2]
    candidates = tuple(int(c) for c in candidates)
    index = torch.as_tensor(index, device=x.device).reshape(1)

    def pick(operators):
        return torch.index_select(operators, 0, index)[0].to(x.dtype)

    if x.dtype != torch.float32:
        rows_down, rows_up = (pick(t) for t in _resample_stages(side, side, candidates,
                                                                x.dtype, x.device))
        cols_down, cols_up = (pick(t) for t in _resample_stages(x.shape[-1], side, candidates,
                                                                x.dtype, x.device))
        down = ops.matmul(ops.matmul(rows_down, x), cols_down.T)
        return ops.matmul(ops.matmul(rows_up, down), cols_up.T)
    rows = pick(_resample_operators(side, side, candidates, x.device))
    cols = pick(_resample_operators(x.shape[-1], side, candidates, x.device))
    return rows @ x @ cols.T


@functools.lru_cache()
def _gaussian_filter(kernel, std, device):
    """:func:`gkern` in float32 on ``device``, copied there once (a copy from
    the host waits for the device's queue)."""
    return torch.as_tensor(gkern(kernel, std), dtype=torch.float32, device=device)


def gaussian(x, kernel=5, std=0.83):
    """Depthwise Gaussian blur (reflect padded), clipped to [0,1]."""
    y = ops.depthwise_conv2d(x, _gaussian_filter(int(kernel), float(std), x.device),
                             pad_mode='reflect')
    return ops.clip(y, 0.0, 1.0)


def _sharpen_filter(strength, hsv):
    gk = np.array([[-0.0833, -0.1667, -0.0833],
                   [-0.1667, 0.0, -0.1667],
                   [-0.0833, -0.1667, -0.0833]])
    gk = strength * gk / np.abs(gk.sum())
    gk[1, 1] = strength + 1
    gfilter = repeat_2dfilter(gk, 3)
    if hsv:
        # identity on the HSV saturation channel, with the reference's
        # pass-through tap at kernel position (2, 2), not the center
        gfilter[:, :, 1:2, 1:2] = 0
        gfilter[2, 2, 1:2, 1:2] = 1
    return gfilter.astype(np.float32)


@functools.lru_cache()
def _sharpen_kernel(strength, hsv, device):
    """The sharpen filter's diagonal (3, 3, 3) in float32 on ``device``,
    copied there once."""
    k = _sharpen_filter(strength, hsv)[:, :, range(3), range(3)]
    return torch.as_tensor(k, dtype=torch.float32, device=device)


def sharpen(x, strength=1.0, hsv=True):
    """Unsharp-mask style sharpening, by default of H and V in HSV space."""
    kpc = _sharpen_kernel(float(strength), hsv, x.device)
    if hsv:
        y = color.rgb_to_hsv(x)
        y = ops.depthwise_conv2d(y, kpc, pad_mode='symmetric')
        y = color.hsv_to_rgb(y)
    else:
        y = ops.depthwise_conv2d(x, kpc, pad_mode='symmetric')
    return ops.clip(y, 0.0, 1.0)


def jpeg(x, quality=80):
    """Soft-rounding differentiable JPEG at an integer quality (the
    reference's ``differentiable_jpeg``, on NCHW), in float32 whatever x's
    dtype, as the reference's codec casts its input."""
    return jpeg_forward_nchw(x.to(torch.float32), *qtables(int(quality), x.device))[0]


@functools.lru_cache()
def _sharpen_parts(dtype, device):
    """The sharpen filter's fixed parts on ``device``: its surround in
    ``dtype``, the center tap's mask and the saturation channel's
    pass-through kernel (float32)."""
    base = np.array([[-0.0833, -0.1667, -0.0833],
                     [-0.1667, 0.0, -0.1667],
                     [-0.0833, -0.1667, -0.0833]])
    center = np.zeros((3, 3), dtype=bool)
    center[1, 1] = True
    ident = np.zeros((3, 3))
    ident[2, 2] = 1.0
    return (torch.as_tensor(base, dtype=dtype, device=device),
            torch.as_tensor(center, device=device),
            torch.as_tensor(ident, dtype=torch.float32, device=device))


def sharpen_traced(x, strength, hsv=True):
    """:func:`sharpen` with the strength in a 0-d tensor (or a float). As in
    the reference, the filter's surround is rounded to x's dtype (and its
    sum too) but the filter is float32."""
    base, center, ident = _sharpen_parts(x.dtype, x.device)
    strength = torch.as_tensor(strength, dtype=torch.float32, device=x.device)
    total = torch.abs(base.sum()).to(torch.float32)
    gk = torch.where(center, strength + 1.0, strength * base.to(torch.float32) / total)
    if hsv:
        # identity on the saturation channel, with the reference's pass-through
        # tap at kernel position (2, 2)
        kpc = torch.stack([gk, ident, gk], dim=-1)            # (3, 3, C) per channel
        y = color.hsv_to_rgb(ops.depthwise_conv2d(color.rgb_to_hsv(x), kpc,
                                                  pad_mode='symmetric'))
    else:
        kpc = torch.stack([gk, gk, gk], dim=-1)
        y = ops.depthwise_conv2d(x, kpc, pad_mode='symmetric')
    return ops.clip(y, 0.0, 1.0)


def gaussian_traced(x, std, kernel=5):
    """:func:`gaussian` with the std in a 0-d tensor (or a float); the filter
    is float32 whatever x's dtype, as the reference's is."""
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    coords = torch.arange(kernel, dtype=torch.float32, device=x.device) - (kernel - 1) / 2.0
    g1 = torch.exp(-0.5 * (coords / std) ** 2)
    g2 = torch.outer(g1, g1)
    y = ops.depthwise_conv2d(x, g2 / g2.sum(), pad_mode='reflect')
    return ops.clip(y, 0.0, 1.0)


def jpeg_traced(x, quality):
    """Soft-rounding JPEG with the quality in a 0-d tensor: its tables are
    built on the device (``jpeg_qtable_traced``). In x's dtype, as the
    reference's is: K1 for float32, the plain blockified form otherwise."""
    quality = torch.as_tensor(quality, dtype=torch.float32, device=x.device)
    return jpeg_forward_nchw(x, jpeg_qtable_traced(quality, 0),
                             jpeg_qtable_traced(quality, 1))[0]


def awgn(x, strength=0.025, noise=None, generator=None):
    """Additive white Gaussian noise of standard deviation ``strength``, then
    soft uint8 quantization and a clip to [0, 1].

    ``noise``: standard normal noise of x's shape; without it the noise is
    drawn on x's device from ``generator`` (a ``torch.Generator``) in
    float32 and rounded to x's dtype once, where the reference draws it in
    x's dtype. ``strength``: a float, or a 0-d tensor (which promotes x to
    its dtype, as a jax array does)."""
    if noise is None:
        if generator is None:
            raise ValueError('awgn takes its noise or a torch.Generator to draw it from')
        noise = torch.randn(x.shape, generator=generator, device=x.device)
    noise = noise.to(x.dtype)
    if torch.is_tensor(strength):
        dtype = torch.promote_types(x.dtype, strength.dtype)
        y = x.to(dtype) + strength * noise.to(dtype)
    else:
        y = x + ops.const(float(strength), x.dtype) * noise
    return quantization.quantize_and_clip(y)


class _IntegerPow(torch.autograd.Function):
    """``lax.integer_pow``: x**n by binary exponentiation, each product
    rounded to x's dtype, with its gradient g·(n·x**(n-1)) (not the
    products' own gradients, which round differently)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.save_for_backward(x)
        ctx.n = n
        return _integer_pow(x, n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (ctx.n * _integer_pow(x, ctx.n - 1)), None


def _integer_pow(x, n):
    if n == 0:
        return torch.ones_like(x)
    acc, base, m = None, x, abs(n)
    while m:
        if m & 1:
            acc = base if acc is None else acc * base
        m >>= 1
        if m:
            base = base * base
    return acc if n > 0 else 1.0 / acc


def _power(x, exponent):
    """``jnp.power(x, exponent)``: a Python int by :class:`_IntegerPow`; a
    float rounded to x's dtype; a tensor promotes x to its dtype."""
    if isinstance(exponent, (int, np.integer)) and not isinstance(exponent, bool):
        return _IntegerPow.apply(x, int(exponent))
    if torch.is_tensor(exponent):
        return torch.pow(x.to(torch.promote_types(x.dtype, exponent.dtype)), exponent)
    return torch.pow(x, ops.const(float(exponent), x.dtype))


def gamma(x, strength=2.0):
    """Gamma round trip: x**s (x clipped to 1e-9 below), soft uint8
    quantization, then back with the 1/s power of the result clipped to
    [1/255, 1]. ``strength``: an int, a float or a 0-d tensor, each taken
    as ``jnp.power`` takes it."""
    y = _power(torch.maximum(x, ops.scalar(1e-9, x.dtype, x.device)), strength)
    y = quantization.soft_quantization(y)
    return _power(ops.clip(y, 1.0 / 255, 1.0), 1.0 / strength)


class _WindowMedian(torch.autograd.Function):
    """The median of each pixel's ``window`` x ``window`` reflect-padded
    neighbourhood: the element at ``position`` of a stable sort of its
    ``window``² shifted views stacked in (dy, dx) order, where the views
    that the ``low`` / ``high`` masks (``window``², or None) pick are -inf /
    +inf.

    The backward sends each pixel's cotangent to the one neighbour that the
    sort put at ``position``: of tied neighbours the one that jnp.sort's
    (stable) gradient picks. It sums them into the image view by view and
    then folds the padding back, in a fixed order and with no atomics, so
    the bits do not change from run to run, nor with views that only add
    zeros (``median_switch`` against ``median``)."""

    @staticmethod
    def forward(ctx, x, window, low, high, position):
        xp = ops.pad2d(x, window // 2, 'reflect')
        # the reshape copies the overlapping views, so the masks fill that copy
        stack = xp.unfold(-2, window, 1).unfold(-2, window, 1).reshape(*x.shape,
                                                                      window * window)
        if low is not None:
            stack.masked_fill_(low, float('-inf')).masked_fill_(high, float('inf'))
        values, order = torch.sort(stack, dim=-1, stable=True)
        ctx.window = window
        ctx.save_for_backward(order[..., position].to(torch.int16))
        return values[..., position].contiguous()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        choice, = ctx.saved_tensors
        window = ctx.window
        pad = window // 2
        h, w = g.shape[-2:]
        grad = g.new_zeros(*g.shape[:-2], h + 2 * pad, w + 2 * pad)
        zero = g.new_zeros(())
        for d in range(window * window):
            dy, dx = divmod(d, window)
            grad[..., dy:dy + h, dx:dx + w] += torch.where(choice == d, g, zero)
        return _fold_reflect_padding(grad, pad), None, None, None, None


def _fold_reflect_padding(grad, pad):
    """The gradient of ``ops.pad2d(x, pad, 'reflect')`` from its result's:
    each padded row, then each padded column, added onto the one it
    mirrors."""
    for dim in (-2, -1):
        n = grad.shape[dim] - 2 * pad
        inner = grad.narrow(dim, pad, n).clone()
        if pad:
            inner.narrow(dim, 1, pad).add_(grad.narrow(dim, 0, pad).flip(dim))
            inner.narrow(dim, n - 1 - pad, pad).add_(grad.narrow(dim, pad + n, pad).flip(dim))
        grad = inner
    return grad


def _median_kernel(kernel):
    """The reference's window: an even size made odd, at least 1."""
    kernel = int(kernel)
    return max(kernel + 1 if kernel % 2 == 0 else kernel, 1)


def median(x, kernel=3):
    """Median filter over a ``kernel`` x ``kernel`` reflect-padded window
    (an even size made odd)."""
    kernel = _median_kernel(kernel)
    return _WindowMedian.apply(x, kernel, None, None, kernel * kernel // 2)


@functools.lru_cache()
def _median_masks(candidates, device):
    """(low, high) (K, w²) bool masks over the w x w window of the largest
    candidate w: for candidate k, the w² - k² views outside the central
    k x k block, half of them low (-inf) and half high (+inf)."""
    w = max(candidates)
    low = np.zeros((len(candidates), w * w), bool)
    high = np.zeros((len(candidates), w * w), bool)
    for i, k in enumerate(candidates):
        inside = np.zeros((w, w), bool)
        inside[(w - k) // 2:(w + k) // 2, (w - k) // 2:(w + k) // 2] = True
        outside = np.flatnonzero(~inside.reshape(-1))
        low[i, outside[:len(outside) // 2]] = True
        high[i, outside[len(outside) // 2:]] = True
    return torch.as_tensor(low, device=device), torch.as_tensor(high, device=device)


def median_switch(x, index, candidates):
    """``median(x, candidates[index])`` with the index in a 0-d integer tensor
    on x's device (or an int), clamped into range as ``lax.switch`` clamps
    it, picked on the device.

    The w² views of the largest window w are stacked once; for candidate k
    the w² - k² views outside its k x k block become -inf (half of them)
    and +inf (the other half), so the stable sort's middle element (w²//2)
    is the k-window's median, the same element that ``median(x, k)`` picks,
    ties included: equal in value and gradient, bit for bit."""
    candidates = tuple(_median_kernel(k) for k in candidates)
    index = torch.as_tensor(index, device=x.device).reshape(1).clamp(0, len(candidates) - 1)
    low, high = (torch.index_select(m, 0, index)[0]
                 for m in _median_masks(candidates, x.device))
    w = max(candidates)
    return _WindowMedian.apply(x, w, low, high, w * w // 2)


@functools.lru_cache()
def _residual_filter(hsv):
    gk = np.array([[-0.0833, -0.1667, -0.0833],
                   [-0.1667, 1.0, -0.1667],
                   [-0.0833, -0.1667, -0.0833]])
    gfilter = repeat_2dfilter(gk, 3)
    if hsv:
        gfilter[:, :, 1:2, 1:2] = 0
        gfilter[2, 2, 1:2, 1:2] = 1
    return gfilter.astype(np.float32)


def residual(x, hsv=False):
    """High-pass residual filter (reflect padded), by default of RGB; with
    ``hsv`` of H and V, the saturation passed through by the reference's
    tap at kernel position (2, 2). No path of the flow uses it."""
    y = ops.pad2d(x, 1, 'reflect')
    if hsv:
        y = color.rgb_to_hsv(y)
    y = ops.small_conv2d(y, _residual_filter(hsv), padding='VALID')
    if hsv:
        y = color.hsv_to_rgb(y)
    return y


@functools.lru_cache()
def _gaussian_pooled_filter(kernel, std, device):
    """(3, 3, k+1, k+1) OIHW float32 filter of :func:`gaussian_pooled` on
    ``device``: the blur convolved with a 2x2 box (scipy's ``convolve2d``,
    as the reference forms it), on the channel diagonal."""
    from scipy import signal  # a slow import: only where this kernel is made
    k2 = signal.convolve2d(gkern(kernel, std), np.ones((2, 2)) / 4.0, 'full')
    gfilter = np.zeros((kernel + 1, kernel + 1, 3, 3), dtype=np.float32)
    for r in range(3):
        gfilter[:, :, r, r] = k2
    return ops.hwio_to_oihw(gfilter).to(device)


def gaussian_pooled(x, kernel=5, std=0.83):
    """``avg_pool(gaussian(x), 2)`` as one strided convolution with the
    composite (k+1)² kernel: the full-resolution blur is never written.
    The trailing clip of :func:`gaussian` is a no-op on [0, 1] data
    (a normalized non-negative kernel), so it is left out, as there."""
    kernel = int(kernel)
    xp = ops.pad2d(x, kernel // 2, 'reflect')
    return ops.conv2d(xp, _gaussian_pooled_filter(kernel, float(std), x.device),
                      padding='VALID', stride=2)


@functools.lru_cache()
def _resample_pooled_filter(device):
    """(3, 3, 3, 3) OIHW float32 filter of pool2 after a bilinear 2x
    up-resize: the separable stencil [1/8, 3/4, 1/8] on the channel
    diagonal."""
    k1 = np.array([0.125, 0.75, 0.125], np.float32)
    rf = np.zeros((3, 3, 3, 3), np.float32)
    for r in range(3):
        rf[:, :, r, r] = np.outer(k1, k1)
    return ops.hwio_to_oihw(rf).to(device)


def resample_pooled(x, factor=50):
    """``avg_pool(resample(x, factor), 2)`` where the up-resize is exactly 2x
    (factor 50): the fixed 3-tap stencil, edge clamped, on the
    down-resized image, so the full-resolution up-resize is never written.
    Other factors take the two-op form."""
    side = x.shape[-2]
    size = _resample_size(side, factor)
    if 2 * size != side:
        return ops.avg_pool(resample(x, factor), 2)
    down = F.pad(resize_bilinear(x, size, size), (1, 1, 1, 1), mode='replicate')
    return ops.conv2d(down, _resample_pooled_filter(x.device), padding='VALID')


def _per_255(strength):
    """awgn's strength on the 0-255 scale as a standard deviation on [0, 1]:
    a Python float's quotient, or a tensor's divided on its device."""
    if torch.is_tensor(strength):
        return strength / ops.scalar(255.0, strength.dtype, strength.device)
    return strength / 255.0


# Registry used by the workflow: (x, strength, noise) → manipulated image;
# ``noise`` is awgn's (x's shape) and the others take none
MANIPULATIONS = {
    'sharpen': lambda x, s, noise=None: sharpen(x, s, hsv=True),
    'resample': lambda x, s, noise=None: resample(x, s),
    'gaussian': lambda x, s, noise=None: gaussian(x, 5, s),
    'jpeg': lambda x, s, noise=None: jpeg(x, s),
    'awgn': lambda x, s, noise=None: awgn(x, _per_255(s), noise),
    'gamma': lambda x, s, noise=None: gamma(x, s),
    'median': lambda x, s, noise=None: median(x, s),
}

# (x, strength tensor, noise) → manipulated image; resample and median take
# resample_switch and median_switch
TRACED_MANIPULATIONS = {
    'sharpen': lambda x, s, noise=None: sharpen_traced(x, s, hsv=True),
    'gaussian': lambda x, s, noise=None: gaussian_traced(x, s, 5),
    'jpeg': lambda x, s, noise=None: jpeg_traced(x, s),
    'awgn': lambda x, s, noise=None: awgn(x, _per_255(s), noise),
    'gamma': lambda x, s, noise=None: gamma(x, s),
}

# the exact fused manipulate → avg_pool(2) branches at a fixed strength,
# used only by ``_manipulate(pool=True)``, which no entry point sets
POOLED_MANIPULATIONS = {
    'gaussian': lambda x, s, noise=None: gaussian_pooled(x, 5, s),
    'resample': lambda x, s, noise=None: resample_pooled(x, s),
}

DEFAULT_STRENGTHS = {'sharpen': 1, 'resample': 50, 'gaussian': 0.83, 'jpeg': 80,
                     'awgn': 5.1, 'gamma': 3, 'median': 3}

# the ranges a randomized strength is drawn from
STRENGTH_RANGES = {
    'sharpen': (0.25, 1.5),
    'resample': (40, 90),
    'gaussian': (0.5, 7),
    'jpeg': (50, 90),
    'awgn': (1, 5),
    'gamma': (1, 5),
    'median': (3, 9),
}
