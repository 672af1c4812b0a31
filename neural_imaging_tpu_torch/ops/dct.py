"""
8x8 block DCT for the differentiable JPEG codec: blockify as reshape/permute
and the 2-D DCT as two small matrix products per block. Port of
``neural_imaging_tpu/ops/dct.py``.
"""
import functools

import numpy as np
import torch


@functools.lru_cache()
def dct_matrix(n=8):
    """Orthonormal DCT-II matrix D[k, m] = c_k cos((2m+1)kπ/2n), float32.

    Built in float64 and cast once, exactly as the reference does. The CUDA
    kernel receives this same matrix: a cosine evaluated on the card gives
    other last bits, and those move coefficients across rounding
    boundaries."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos((2 * m + 1) * k * np.pi / (2 * n)) * np.sqrt(2.0 / n)
    d[0, :] = np.sqrt(1.0 / n)
    return d.astype(np.float32)


@functools.lru_cache()
def dct_tensor(device, n=8):
    """:func:`dct_matrix` as a float32 tensor on ``device`` (cached per device)."""
    return torch.as_tensor(dct_matrix(n), device=device)


def blockify(x, block=8):
    """(…, H, W) → (…, H/b, W/b, b, b) non-overlapping blocks.

    For NCHW input this is (N, C, H/b, W/b, b, b), the layout of the
    reference's ``blockify``."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // block, block, w // block, block)
    return x.transpose(-3, -2)


def deblockify(blocks):
    """(…, H/b, W/b, b, b) → (…, H, W)."""
    *lead, hb, wb, b, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, hb * b, wb * b)


def _in_float32(blocks):
    """(D, blocks) in float32, D first rounded to the blocks' dtype, as the
    reference casts it."""
    d = dct_tensor(blocks.device, blocks.shape[-1]).to(blocks.dtype)
    return d.to(torch.float32), blocks.to(torch.float32)


def dct2d(blocks):
    """Forward 2-D DCT of the trailing (8, 8) block axes: D X Dᵀ, summed in
    float32 and rounded to the blocks' dtype once."""
    d, x = _in_float32(blocks)
    return (d @ x @ d.T).to(blocks.dtype)


def idct2d(coeffs):
    """Inverse 2-D DCT of the trailing (8, 8) block axes: Dᵀ X D (as :func:`dct2d`)."""
    d, x = _in_float32(coeffs)
    return (d.T @ x @ d).to(coeffs.dtype)
