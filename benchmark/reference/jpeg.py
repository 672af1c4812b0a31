"""
The reference differentiable JPEG: JFIF colour transform, per 8x8 block
DCT-II, division by the IJG tables of a quality, soft rounding (round half to
even forward, the derivative of x - sin(2πx)/2π backward), multiplication
back, inverse DCT, clip to [0, 1] with jnp.clip's gradient. No chroma
subsampling.
"""
import numpy as np
import torch

from benchmark.reference import ops

# ITU-T T.81 Annex K tables
LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
                np.float32).reshape(8, 8)
CHROMA = np.full((8, 8), 99, np.float32)
CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
RGB_TO_YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
YCC_OFFSET = np.array([0.0, 128.0, 128.0], np.float32)
YCC_TO_RGB = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]],
                      np.float32)
RGB_OFFSET = np.array([-1.402 * 128, 1.058272 * 128, -1.772 * 128], np.float32)


def qtable(quality, luma=True):
    """The IJG table of an integer quality."""
    q = float(np.clip(quality, 1, 100))
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    return np.clip(np.floor(((LUMA if luma else CHROMA) * scale + 50.0) / 100.0),
                   1, 255).astype(np.float32)


def dct_matrix():
    """Orthonormal 8-point DCT-II matrix, built in float64, float32."""
    k, m = np.arange(8)[:, None], np.arange(8)[None, :]
    d = np.cos((2 * m + 1) * k * np.pi / 16) * np.sqrt(2.0 / 8)
    d[0, :] = np.sqrt(1.0 / 8)
    return d.astype(np.float32)


def _affine(x, matrix, offset):
    m = torch.as_tensor(matrix, device=x.device)
    b = torch.as_tensor(offset, device=x.device)[:, None, None]
    return torch.einsum('nchw,kc->nkhw', x, m) + b


def blocks(x):
    """(N, C, H, W) → (N, C, H/8, W/8, 8, 8)."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 8, 8, w // 8, 8).transpose(3, 4)


def unblocks(b):
    n, c, hb, wb, _, _ = b.shape
    return b.transpose(3, 4).reshape(n, c, hb * 8, wb * 8)


def jpeg(x, quality):
    """(N, 3, H, W) RGB in [0, 1] → (decoded RGB, dequantized coefficients
    as (N, 3, H, W) planes)."""
    d = torch.as_tensor(dct_matrix(), device=x.device)
    q = torch.stack([torch.as_tensor(qtable(quality, luma), device=x.device)
                     for luma in (True, False, False)])[None, :, None, None]
    ycc = _affine(255.0 * x, RGB_TO_YCC, YCC_OFFSET) - 127.0
    coeffs = d @ blocks(ycc) @ d.T
    xq = ops.soft_round(coeffs / q) * q
    y = unblocks(d.T @ xq @ d)
    rgb = _affine(y + 127.0, YCC_TO_RGB, RGB_OFFSET)
    return ops.clip(rgb / 255.0, 0.0, 1.0), unblocks(xq)
