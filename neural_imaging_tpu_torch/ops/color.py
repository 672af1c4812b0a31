"""
Color space conversions on channels-first tensors (channel axis -3):
JPEG-standard RGB↔YCbCr affine transforms and RGB↔HSV (tf.image parity, used
by the sharpen manipulation). Port of ``neural_imaging_tpu/ops/color.py``.
"""
import numpy as np
import torch

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


def _affine(x, matrix, offset):
    m = torch.as_tensor(matrix, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(offset, dtype=x.dtype, device=x.device)
    return torch.einsum('...chw,kc->...khw', x, m) + b[:, None, None]


def rgb_to_ycbcr(x255):
    """255-scaled RGB (…, 3, H, W) → YCbCr (Y in [0,255], Cb/Cr centered at 128)."""
    return _affine(x255, _F_MATRIX, _F_OFFSET)


def ycbcr_to_rgb(ycc):
    """YCbCr (…, 3, H, W) → 255-scaled RGB."""
    return _affine(ycc, _I_MATRIX, _I_OFFSET)


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
    h = torch.where(positive, h / 6.0, torch.zeros_like(h))

    v_pos = v > 0
    s = torch.where(v_pos, rng / torch.where(v_pos, v, torch.ones_like(v)),
                    torch.zeros_like(v))
    return torch.stack([h, s, v], dim=-3)


def hsv_to_rgb(hsv):
    """HSV (H in [0,1], …, 3, H, W) → RGB [0,1] (tf.image.hsv_to_rgb parity)."""
    h, s, v = hsv.unbind(-3)
    dh = torch.remainder(h, 1.0) * 6.0
    dr = torch.clamp(torch.abs(dh - 3.0) - 1.0, 0.0, 1.0)
    dg = torch.clamp(-torch.abs(dh - 2.0) + 2.0, 0.0, 1.0)
    db = torch.clamp(-torch.abs(dh - 4.0) + 2.0, 0.0, 1.0)
    one_minus_s = 1.0 - s
    rgb = torch.stack([one_minus_s + s * dr, one_minus_s + s * dg, one_minus_s + s * db],
                      dim=-3)
    return v.unsqueeze(-3) * rgb
