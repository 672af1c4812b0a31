"""
Differentiable image manipulations that the forensic workflow learns to
classify, on NCHW batches in [0,1]. Port of the four entries of
``neural_imaging_tpu/ops/manipulations.py`` that the manipulation-
classification forward path runs at fixed strengths: sharpen, resample,
gaussian and jpeg. awgn, gamma, median and the randomized-strength variants
are not ported yet.
"""
import functools

import numpy as np
import torch

from neural_imaging_tpu_torch.models.jpeg import jpeg_forward_nchw, qtables
from neural_imaging_tpu_torch.ops import color, ops
from neural_imaging_tpu_torch.ops.kernels import gkern, repeat_2dfilter


@functools.lru_cache()
def _resize_matrix(n_in, n_out):
    """(n_out, n_in) float32 operator of ``jax.image.resize``'s 1-D 'bilinear'
    resize: half-pixel centers, triangle kernel widened by the scale when
    downsampling (antialiasing), weights normalized per output sample.

    ``F.interpolate`` does not antialias and is a different operator. This
    repeats jax's ``compute_weight_mat`` step by step in float32."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    inv_scale = f32(1.0) / scale
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


def resize_bilinear(x, h_out, w_out):
    """``jax.image.resize(..., 'bilinear')`` of an NCHW batch as two matrix
    products (rows, then columns)."""
    h, w = x.shape[-2:]
    if h_out != h:
        x = torch.as_tensor(_resize_matrix(h, h_out), dtype=x.dtype, device=x.device) @ x
    if w_out != w:
        x = x @ torch.as_tensor(_resize_matrix(w, w_out), dtype=x.dtype, device=x.device).T
    return x


def resample(x, factor=50):
    """Bilinear down-and-back-up resampling by a percentage factor (50 → half size)."""
    if 0 < factor <= 1:
        factor = 100 * factor
    side = x.shape[-2]
    size = side * int(factor) // 100
    return resize_bilinear(resize_bilinear(x, size, size), side, side)


def gaussian(x, kernel=5, std=0.83):
    """Depthwise Gaussian blur (reflect padded), clipped to [0,1]."""
    y = ops.depthwise_conv2d(x, gkern(int(kernel), std), pad_mode='reflect')
    return torch.clamp(y, 0, 1)


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


def sharpen(x, strength=1.0, hsv=True):
    """Unsharp-mask style sharpening, by default of H and V in HSV space."""
    gfilter = _sharpen_filter(float(strength), hsv)
    kpc = gfilter[:, :, range(3), range(3)]          # diagonal: (k, k, 3)
    if hsv:
        y = color.rgb_to_hsv(x)
        y = ops.depthwise_conv2d(y, kpc, pad_mode='symmetric')
        y = color.hsv_to_rgb(y)
    else:
        y = ops.depthwise_conv2d(x, kpc, pad_mode='symmetric')
    return torch.clamp(y, 0, 1)


def jpeg(x, quality=80):
    """Soft-rounding differentiable JPEG at an integer quality (the
    reference's ``differentiable_jpeg``, on NCHW)."""
    return jpeg_forward_nchw(x, *qtables(int(quality), x.device))[0]


# Registry used by the workflow: (x, strength) → manipulated image.
MANIPULATIONS = {
    'sharpen': lambda x, s: sharpen(x, s, hsv=True),
    'resample': lambda x, s: resample(x, s),
    'gaussian': lambda x, s: gaussian(x, 5, s),
    'jpeg': lambda x, s: jpeg(x, s),
}

DEFAULT_STRENGTHS = {'sharpen': 1, 'resample': 50, 'gaussian': 0.83, 'jpeg': 80}
