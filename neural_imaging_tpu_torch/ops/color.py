"""
Color space conversions on channels-first tensors (channel axis -3):
JPEG-standard RGB↔YCbCr affine transforms and RGB↔HSV (tf.image parity, used
by the sharpen manipulation). Port of ``neural_imaging_tpu/ops/color.py``.

In bfloat16 every operation rounds its result to bfloat16, as the
reference's do: the YCbCr transforms sum three exact products in float32 and
round once, then add the rounded offset.
"""
import functools

import numpy as np
import torch

from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.utils import profiling

# JPEG (JFIF) color transform: 255-scale, chroma offset by +128; the inverse
# folds the offsets into its affine part.
_F_MATRIX = np.array([[0.299, 0.587, 0.114],
                      [-0.168736, -0.331264, 0.5],
                      [0.5, -0.418688, -0.081312]], dtype=np.float32)
_F_OFFSET = np.array([0.0, 128.0, 128.0], dtype=np.float32)

_I_MATRIX = np.array([[1.0, 0.0, 1.402],
                      [1.0, -0.344136, -0.714136],
                      [1.0, 1.772, 0.0]], dtype=np.float32)
_I_OFFSET = np.array([-1.402 * 128, 1.058272 * 128, -1.772 * 128], dtype=np.float32)


@functools.lru_cache()
def _affine_tensors(forward, dtype, device):
    """(matrix, offset) of the forward or inverse transform on ``device``,
    copied there once (a copy from the host waits for the device's queue)."""
    matrix, offset = (_F_MATRIX, _F_OFFSET) if forward else (_I_MATRIX, _I_OFFSET)
    return (profiling.to_device(matrix, device, dtype),
            profiling.to_device(offset, device, dtype)[:, None, None])


def _affine(x, forward, precision):
    m, b = _affine_tensors(forward, x.dtype, x.device)
    return ops.at_precision(lambda a, k: torch.einsum('...chw,kc->...khw', a, k), x, m,
                            precision) + b


def rgb_to_ycbcr(x255, precision=None):
    """255-scaled RGB (…, 3, H, W) → YCbCr (Y in [0,255], Cb/Cr centered at
    128); ``precision`` of float32 operands as in ``ops.at_precision``."""
    return _affine(x255, True, precision)


def ycbcr_to_rgb(ycc, precision=None):
    """YCbCr (…, 3, H, W) → 255-scaled RGB."""
    return _affine(ycc, False, precision)


def rgb_to_hsv(rgb):
    """RGB [0,1] (…, 3, H, W) → HSV with H in [0,1] (tf.image.rgb_to_hsv parity)."""
    r, g, b = rgb.unbind(-3)
    v = rgb.amax(-3)
    mn = rgb.amin(-3)
    rng = v - mn
    positive = rng > 0
    safe_rng = torch.where(positive, rng, torch.ones_like(rng))

    h_r = torch.remainder((g - b) / safe_rng, 6.0)
    h_g = (b - r) / safe_rng + 2.0
    h_b = (r - g) / safe_rng + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(positive, h / ops.scalar(6.0, h.dtype, h.device), torch.zeros_like(h))

    v_pos = v > 0
    s = torch.where(v_pos, rng / torch.where(v_pos, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    return torch.stack([h, s, v], dim=-3)


def hsv_to_rgb(hsv):
    """HSV (H in [0,1], …, 3, H, W) → RGB [0,1] (tf.image.hsv_to_rgb parity)."""
    h, s, v = hsv.unbind(-3)
    dh = torch.remainder(h, 1.0) * 6.0
    dr = ops.clip(torch.abs(dh - 3.0) - 1.0, 0.0, 1.0)
    dg = ops.clip(-torch.abs(dh - 2.0) + 2.0, 0.0, 1.0)
    db = ops.clip(-torch.abs(dh - 4.0) + 2.0, 0.0, 1.0)
    one_minus_s = 1.0 - s
    rgb = torch.stack([one_minus_s + s * dr, one_minus_s + s * dg, one_minus_s + s * db],
                      dim=-3)
    return v.unsqueeze(-3) * rgb
