"""
Differentiable image manipulations that the forensic workflow learns to
classify, on NCHW batches in [0,1]. Port of the sharpen, resample, gaussian
and jpeg entries of ``neural_imaging_tpu/ops/manipulations.py``: at a fixed
strength (``MANIPULATIONS``) and with the strength in a 0-d tensor on the
batch's device (``TRACED_MANIPULATIONS``, ``resample_switch``), so that a
training step draws its strengths on the device and never waits on the
host for them. awgn, gamma and median are not ported yet.

A bfloat16 batch (a bfloat16 channel) stays bfloat16 where the reference's
does: filters are built and summed in float32 and each filtered result is
rounded once; each resize product is summed in float32 and rounded; the
fixed-quality jpeg runs in float32, as the reference's codec casts its input.
"""
import functools

import numpy as np
import torch

from neural_imaging_tpu_torch.models.jpeg import jpeg_forward_nchw, jpeg_qtable_traced, qtables
from neural_imaging_tpu_torch.ops import color, ops
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


# Registry used by the workflow: (x, strength) → manipulated image.
MANIPULATIONS = {
    'sharpen': lambda x, s: sharpen(x, s, hsv=True),
    'resample': lambda x, s: resample(x, s),
    'gaussian': lambda x, s: gaussian(x, 5, s),
    'jpeg': lambda x, s: jpeg(x, s),
}

# (x, strength tensor) → manipulated image; resample takes resample_switch
TRACED_MANIPULATIONS = {
    'sharpen': lambda x, s: sharpen_traced(x, s, hsv=True),
    'gaussian': lambda x, s: gaussian_traced(x, s, 5),
    'jpeg': jpeg_traced,
}

DEFAULT_STRENGTHS = {'sharpen': 1, 'resample': 50, 'gaussian': 0.83, 'jpeg': 80}

# the ranges a randomized strength is drawn from
STRENGTH_RANGES = {
    'sharpen': (0.25, 1.5),
    'resample': (40, 90),
    'gaussian': (0.5, 7),
    'jpeg': (50, 90),
}
