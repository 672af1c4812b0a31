"""
Differentiable JPEG: the codec as one function of the image and two
quantization tables, plus the ``DifferentiableJPEG`` and ``JPEG`` wrappers.
Port of ``neural_imaging_tpu/models/jpeg.py`` without the libjpeg codec
(which needs PIL).

Dispatch: a 'soft'-rounding call goes through the fused core
(``ops.hopper.jpeg8x8.jpeg_core``), which launches the CUDA kernel K1 on a
CUDA tensor at every size and takes the plain blockified form on a CPU
tensor. Other roundings take the plain blockified form on any device.
"""
import functools

import numpy as np
import torch

from neural_imaging_tpu_torch.compression.jpeg_helpers import K1_LUMA, K2_CHROMA, jpeg_qtable
from neural_imaging_tpu_torch.ops import color, dct
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper.jpeg8x8 import jpeg_core
from neural_imaging_tpu_torch.utils.device import resolve_device

ROUNDING_APPROXIMATIONS = ('sin', 'harmonic', 'soft')


def _is_number(x):
    return isinstance(x, (int, float, np.integer, np.floating)) and not isinstance(x, bool)


def is_valid_quality(quality):
    if _is_number(quality) and 1 <= quality <= 100:
        return True
    if hasattr(quality, '__getitem__') and len(quality) > 1 and all(1 <= x <= 100 for x in quality):
        return True
    return False


def jpeg_qtable_traced(quality, channel=0):
    """IJG quantization table from a quality held in a tensor (on its device)."""
    quality = torch.clamp(quality.to(torch.float32), 1.0, 100.0)
    scale = torch.where(quality < 50.0, 5000.0 / quality, 200.0 - 2.0 * quality)
    t = torch.as_tensor(K1_LUMA if channel == 0 else K2_CHROMA, device=quality.device)
    return torch.clamp(torch.floor((t * scale + 50.0) / 100.0), 1.0, 255.0)


@functools.lru_cache()
def qtables(quality, device):
    """(luma, chroma) tables of an integer quality as tensors on ``device``."""
    return (torch.as_tensor(jpeg_qtable(quality, 0), device=device),
            torch.as_tensor(jpeg_qtable(quality, 1), device=device))


def jpeg_forward_nchw(x, q_luma, q_chroma, rounding='soft', taylor_terms=5):
    """Differentiable JPEG round trip of an NCHW RGB batch in [0,1].

    :param x: (N, 3, H, W), H and W divisible by 8
    :param q_luma/q_chroma: (8, 8) quantization tables (tensors or arrays)
    :param rounding: 'soft' | 'sin' | 'harmonic' (or 'round' / 'identity')
    :return: (y, coeffs) — the image in [0,1], (N, 3, H, W), and the
        dequantized coefficients as (N, 3, H, W) planes (block (i, j),
        frequency (k, l) at [8i + k, 8j + l])
    """
    n, c, h, w = x.shape
    if c != 3 or h % 8 or w % 8:
        raise ValueError(f'jpeg expects (N, 3, H, W) with H, W divisible by 8, '
                         f'got {tuple(x.shape)}')
    x = x.to(torch.float32)
    planes = (color.rgb_to_ycbcr(255.0 * x) - 127.0).reshape(n * 3, h, w)
    q = torch.stack([torch.as_tensor(t, dtype=torch.float32, device=x.device)
                     for t in (q_luma, q_chroma, q_chroma)])          # (3, 8, 8)
    if rounding == 'soft':
        y, coeffs = jpeg_core(planes.contiguous(), q.repeat(n, 1, 1))
    else:
        qb = q.repeat(n, 1, 1)[:, None, None]
        xq = quant.quantize(dct.dct2d(dct.blockify(planes)) / qb, rounding,
                            taylor_terms=taylor_terms) * qb
        y, coeffs = dct.deblockify(dct.idct2d(xq)), dct.deblockify(xq)
    y = color.ycbcr_to_rgb(y.reshape(n, 3, h, w) + 127.0) / 255.0
    return torch.clamp(y, 0.0, 1.0), coeffs.reshape(n, 3, h, w)


def jpeg_forward(x, q_luma, q_chroma, rounding='soft', taylor_terms=5):
    """:func:`jpeg_forward_nchw` with the reference's NHWC interface: takes
    (N, H, W, 3) and returns (y (N, H, W, 3), coefficients (N, 3, H/8, W/8, 8, 8))."""
    y, coeffs = jpeg_forward_nchw(x.permute(0, 3, 1, 2), q_luma, q_chroma,
                                  rounding, taylor_terms)
    return y.permute(0, 2, 3, 1), dct.blockify(coeffs)


def differentiable_jpeg(x, quality):
    """Soft-rounding JPEG of an NHWC batch at an integer quality."""
    q_luma, q_chroma = qtables(int(quality), x.device)
    return jpeg_forward(x, q_luma, q_chroma)[0]


class DifferentiableJPEG:
    """``jpeg_forward`` with its quantization tables held in ``self.params``
    (trainable when ``trainable=True``)."""

    def __init__(self, quality=None, rounding_approximation='sin',
                 rounding_approximation_steps=5, trainable=False, device='cuda'):
        if quality is not None and not is_valid_quality(quality):
            raise ValueError('Invalid JPEG quality: requires int in [1,100] or an iterable of them')
        if rounding_approximation is not None and rounding_approximation not in ROUNDING_APPROXIMATIONS:
            raise ValueError(f'Unsupported rounding approximation: {rounding_approximation}')
        self.device = resolve_device(device)
        self.quality = quality
        self.trainable = trainable
        self.rounding_approximation = rounding_approximation or 'soft'
        self.rounding_approximation_steps = rounding_approximation_steps
        if _is_number(quality):
            q_luma, q_chroma = jpeg_qtable(quality, 0), jpeg_qtable(quality, 1)
        else:
            q_luma = q_chroma = np.ones((8, 8), dtype=np.float32)
        self.params = {
            name: torch.tensor(t, device=self.device, requires_grad=trainable)
            for name, t in (('q_mtx_luma', q_luma), ('q_mtx_chroma', q_chroma))}

    def __call__(self, x, params=None, q_luma=None, q_chroma=None):
        """NHWC batch → (y, coefficients), as :func:`jpeg_forward`."""
        params = params if params is not None else self.params
        q_luma = params['q_mtx_luma'] if q_luma is None else q_luma
        q_chroma = params['q_mtx_chroma'] if q_chroma is None else q_chroma
        return jpeg_forward(x.to(torch.float32), q_luma, q_chroma,
                            rounding=self.rounding_approximation,
                            taylor_terms=self.rounding_approximation_steps)


class JPEG:
    """JPEG channel codec with the differentiable approximation ('soft' /
    'sin' / 'harmonic') and scalar, range or set quality randomization. The
    reference's 'libjpeg' codec is not ported."""

    def __init__(self, quality=None, codec='soft', trainable=False, rng=None,
                 device='cuda'):
        if codec not in ('soft', 'sin', 'harmonic'):
            raise ValueError(f'Unsupported codec version: {codec}')
        self.codec = codec
        self.quality = quality
        self.trainable = trainable
        self._rng = rng or np.random.default_rng()
        self._model = DifferentiableJPEG(quality, codec, trainable=trainable, device=device)

    def _resolve_quality(self, quality):
        quality = self.quality if quality is None else quality
        if not is_valid_quality(quality):
            raise ValueError('Invalid or unspecified JPEG quality!')
        if hasattr(quality, '__getitem__') and len(quality) > 2:
            return int(self._rng.choice(quality))
        if hasattr(quality, '__getitem__') and len(quality) == 2:
            return int(self._rng.integers(quality[0], quality[1]))
        return int(quality)

    def process(self, batch_x, quality=None):
        """Compress an NHWC RGB batch; quality as in the constructor."""
        quality = self._resolve_quality(quality)
        if self.trainable or quality == self.quality:
            return self._model(batch_x)[0]
        q_luma, q_chroma = qtables(quality, batch_x.device)
        return self._model(batch_x, q_luma=q_luma, q_chroma=q_chroma)[0]

    def __repr__(self):
        return f'JPEG(quality={self.quality},codec="{self.codec}",trainable={self.trainable})'
