"""
Differentiable JPEG: the codec as one function of the image and two
quantization tables, plus the ``DifferentiableJPEG`` and ``JPEG`` wrappers.
Port of ``neural_imaging_tpu/models/jpeg.py``; its 'libjpeg' codec runs on
the host through the port's own libjpeg-exact codec
(``compression/baseline_jpeg.py``).

Dispatch, as the reference routes it: a call with a matrix-unit
``precision`` (a bfloat16 channel or manipulation) takes the plane form
(:func:`_jpeg_forward_planes`, plain PyTorch, in the input's dtype); a
float32 'soft'-rounding call goes through the fused core
(``ops.hopper.jpeg8x8.jpeg_core``), which launches the CUDA kernel K1 on a
CUDA tensor at every size and takes the plain blockified form on a CPU
tensor; anything else takes the plain blockified form in the input's dtype.
"""
import functools

import numpy as np
import torch
from torch import nn

from neural_imaging_tpu_torch.compression import jpeg_helpers
from neural_imaging_tpu_torch.compression.jpeg_helpers import (K1_LUMA, K2_CHROMA, jpeg_qf_estimation,
                                                              jpeg_qtable)
from neural_imaging_tpu_torch.models.base import TorchModel
from neural_imaging_tpu_torch.ops import color, dct, ops
from neural_imaging_tpu_torch.ops import quantization as quant
from neural_imaging_tpu_torch.ops.hopper.jpeg8x8 import jpeg_core
from neural_imaging_tpu_torch.utils import profiling, stats
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


@functools.lru_cache()
def _base_table(channel, device):
    """The Annex-K table of a channel on ``device``, copied there once."""
    return profiling.to_device(K1_LUMA if channel == 0 else K2_CHROMA, device)


def jpeg_qtable_traced(quality, channel=0):
    """IJG quantization table from a quality held in a tensor (on its device)."""
    quality = torch.clamp(quality.to(torch.float32), 1.0, 100.0)
    scale = torch.where(quality < 50.0, 5000.0 / quality, 200.0 - 2.0 * quality)
    t = _base_table(channel, quality.device)
    return torch.clamp(torch.floor((t * scale + 50.0) / 100.0), 1.0, 255.0)


@functools.lru_cache()
def qtables(quality, device):
    """(luma, chroma) tables of an integer quality as tensors on ``device``."""
    return (profiling.to_device(jpeg_qtable(quality, 0), device),
            profiling.to_device(jpeg_qtable(quality, 1), device))


def jpeg_forward_nchw(x, q_luma, q_chroma, rounding='soft', taylor_terms=5, precision=None):
    """Differentiable JPEG round trip of an NCHW RGB batch in [0,1].

    :param x: (N, 3, H, W), H and W divisible by 8; float32 or bfloat16
    :param q_luma/q_chroma: (8, 8) quantization tables (tensors or arrays)
    :param rounding: 'soft' | 'sin' | 'harmonic' (or 'round' / 'identity')
    :param precision: None, or the matrix-unit precision of the color and
        DCT products ('highest' | 'high' | 'default'), which selects the
        plane form; ``ops.at_precision`` says what each does to float32
        operands, and bfloat16 operands are summed in float32 either way
    :return: (y, coeffs) — the image in [0,1] in x's dtype, (N, 3, H, W),
        and the dequantized coefficients as (N, 3, H, W) planes (block
        (i, j), frequency (k, l) at [8i + k, 8j + l])
    """
    n, c, h, w = x.shape
    if c != 3 or h % 8 or w % 8:
        raise ValueError(f'jpeg expects (N, 3, H, W) with H, W divisible by 8, '
                         f'got {tuple(x.shape)}')
    if precision is not None:
        return _jpeg_forward_planes(x, q_luma, q_chroma, rounding, taylor_terms, precision)
    dt = x.dtype
    planes = (color.rgb_to_ycbcr(255.0 * x) - 127.0).reshape(n * 3, h, w)
    q = _tables(q_luma, q_chroma, dt, x.device)                      # (3, 8, 8)
    if rounding == 'soft' and dt == torch.float32:
        y, coeffs = jpeg_core(planes.contiguous(), q.repeat(n, 1, 1))
    else:
        qb = q.repeat(n, 1, 1)[:, None, None]
        xq = quant.quantize(dct.dct2d(dct.blockify(planes)) / qb, rounding,
                            taylor_terms=taylor_terms) * qb
        y, coeffs = dct.deblockify(dct.idct2d(xq)), dct.deblockify(xq)
    return _to_rgb(y.reshape(n, 3, h, w), None), coeffs.reshape(n, 3, h, w)


def _tables(q_luma, q_chroma, dtype, device):
    """The (3, 8, 8) stack of a batch's tables (luma, chroma, chroma) in ``dtype``."""
    return torch.stack([profiling.to_device(t, device).to(dtype)
                        for t in (q_luma, q_chroma, q_chroma)])


def _to_rgb(ycc, precision):
    """Centered YCbCr planes → RGB in [0, 1], clipped (``jnp.clip``'s gradient)."""
    rgb = color.ycbcr_to_rgb(ycc + 127.0, precision)
    return ops.clip(rgb / ops.scalar(255.0, rgb.dtype, rgb.device), 0.0, 1.0)


def _blockdiag_mm(a, d, precision):
    """``a @ (I ⊗ d)`` along a's last axis: each aligned run of 8 samples
    times the 8x8 ``d``, at ``precision`` (``ops.matmul``)."""
    *lead, size = a.shape
    return ops.matmul(a.reshape(*lead, size // 8, 8), d, precision).reshape(*lead, size)


def _jpeg_forward_planes(x, q_luma, q_chroma, rounding, taylor_terms, precision):
    """The reference's plane form of the codec, in x's dtype: the 2-D block
    DCT as products with the block-diagonal operators I ⊗ D, each product's
    result rounded to x's dtype, the coefficients kept transposed (…, W, H)
    through quantization.

    The products are computed blockwise, an (…, 8) row of each aligned 8
    samples times the 8x8 D, not as the reference's dense (H, H) and (W, W)
    products with I ⊗ D: the zero entries add exact zeros, so both give the
    same sums up to their float32 summation order, at an 8th of the work."""
    n, _, h, w = x.shape
    dt = x.dtype
    d = dct.dct_tensor(x.device)
    ycc = color.rgb_to_ycbcr(255.0 * x, precision) - 127.0
    t = _blockdiag_mm(ycc, d.T, precision).transpose(-1, -2)        # DCT over W → (…, W, H)
    xt = _blockdiag_mm(t, d.T, precision)                          # DCT over H
    qft = _tables(q_luma, q_chroma, dt, x.device).transpose(-1, -2).repeat(1, w // 8, h // 8)
    xqt = quant.quantize(xt / qft, rounding, taylor_terms=taylor_terms) * qft
    y = _blockdiag_mm(_blockdiag_mm(xqt, d, precision).transpose(-1, -2), d, precision)
    return _to_rgb(y, precision), xqt.transpose(-1, -2)


def jpeg_forward(x, q_luma, q_chroma, rounding='soft', taylor_terms=5, precision=None):
    """:func:`jpeg_forward_nchw` with the reference's NHWC interface: takes
    (N, H, W, 3) and returns (y (N, H, W, 3), coefficients (N, 3, H/8, W/8, 8, 8))."""
    y, coeffs = jpeg_forward_nchw(x.permute(0, 3, 1, 2), q_luma, q_chroma,
                                  rounding, taylor_terms, precision)
    return y.permute(0, 2, 3, 1), dct.blockify(coeffs)


def differentiable_jpeg(x, quality):
    """Soft-rounding JPEG of an NHWC batch at an integer quality."""
    q_luma, q_chroma = qtables(int(quality), x.device)
    return jpeg_forward(x, q_luma, q_chroma)[0]


class DifferentiableJPEG:
    """``jpeg_forward`` with its quantization tables held in ``self.params``
    (``nn.Parameter``s when ``trainable=True``)."""

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
        tables = (('q_mtx_luma', q_luma), ('q_mtx_chroma', q_chroma))
        self.params = {name: torch.tensor(t, device=self.device) for name, t in tables}
        if trainable:
            self.params = {name: nn.Parameter(t) for name, t in self.params.items()}

    @property
    def q_mtx_luma(self):
        return self.params['q_mtx_luma'].detach().cpu().numpy()

    @property
    def q_mtx_chroma(self):
        return self.params['q_mtx_chroma'].detach().cpu().numpy()

    def __call__(self, x, params=None, q_luma=None, q_chroma=None):
        """NHWC batch → (y, coefficients), as :func:`jpeg_forward`."""
        params = params if params is not None else self.params
        q_luma = params['q_mtx_luma'] if q_luma is None else q_luma
        q_chroma = params['q_mtx_chroma'] if q_chroma is None else q_chroma
        return jpeg_forward(x.to(torch.float32), q_luma, q_chroma,
                            rounding=self.rounding_approximation,
                            taylor_terms=self.rounding_approximation_steps)


class JPEG(TorchModel):
    """JPEG channel codec: the differentiable approximation ('soft' / 'sin' /
    'harmonic') on the device, or libjpeg's codec ('libjpeg') on the host,
    with scalar, range or set quality randomization. Its checkpoint holds the
    q-tables of a trainable codec and nothing otherwise."""

    def __init__(self, quality=None, codec='soft', trainable=False, rng=None,
                 device='cuda'):
        if codec not in ('libjpeg', 'soft', 'sin', 'harmonic'):
            raise ValueError(f'Unsupported codec version: {codec}')
        super().__init__(None, device)
        self.codec = codec
        self.quality = quality
        self.trainable = trainable
        self._rng = rng or np.random.default_rng()
        self._model = None if codec == 'libjpeg' else DifferentiableJPEG(
            quality, codec, trainable=trainable, device=device)

    def reset_performance_stats(self):
        self.performance = self._reset_performance(['entropy', 'ssim', 'psnr'])

    def count_parameters(self):
        if self._model is None or not self.trainable:
            return 0
        return sum(t.numel() for t in self._model.params.values())

    def checkpoint(self):
        if self._model is None or not self.trainable:
            return {}
        return {name: t.detach().cpu().numpy() for name, t in self._model.params.items()}

    def loss(self, batch_c, batch_C, entropy=None):
        """Mean squared distortion of the channel (``entropy`` is unused: JPEG
        has no rate to train)."""
        return torch.mean((batch_c - batch_C) ** 2)

    def _resolve_quality(self, quality):
        """A quality to use now: the number, an integer drawn from [lo, hi) of
        a 2-range, or a choice from a longer set (``self._rng``)."""
        quality = self.quality if quality is None else quality
        if not is_valid_quality(quality):
            raise ValueError('Invalid or unspecified JPEG quality!')
        if hasattr(quality, '__getitem__') and len(quality) > 2:
            return int(self._rng.choice(quality))
        if hasattr(quality, '__getitem__') and len(quality) == 2:
            return int(self._rng.integers(quality[0], quality[1]))
        return int(quality)

    def process(self, batch_x, quality=None, return_entropy=False):
        """Compress an NHWC RGB batch; quality as in the constructor. With
        ``return_entropy`` also the empirical entropy (bits) of the rounded
        dequantized coefficients, as (image, entropy). The 'libjpeg' codec
        returns the decoded batch as numpy (float32 in [0, 1]) and NaN for
        the entropy, as the reference does."""
        quality = self._resolve_quality(quality)
        if self._model is None:
            if torch.is_tensor(batch_x):
                batch_x = batch_x.detach().cpu().numpy()
            y = jpeg_helpers.compress_batch(np.asarray(batch_x), quality)[0]
            return (y, np.nan) if return_entropy else y
        x = profiling.to_device(batch_x, self.device, torch.float32)
        with torch.no_grad():
            if self.trainable or quality == self.quality:
                y, coeffs = self._model(x)
            else:
                q_luma, q_chroma = qtables(quality, self.device)
                y, coeffs = self._model(x, q_luma=q_luma, q_chroma=q_chroma)
        if return_entropy:
            coeffs = coeffs.cpu().numpy()
            return y, stats.entropy(np.round(coeffs), np.arange(-1024, 1025))
        return y

    def process_with_params(self, batch_x, params):
        """Differentiable round trip of an NHWC batch through explicit
        (trainable) tables ``params`` {'q_mtx_luma', 'q_mtx_chroma'}: (y,
        coefficients), as :func:`jpeg_forward`."""
        if self._model is None:
            raise ValueError('libjpeg codec has no differentiable parameters')
        return self._model(batch_x, params=params)

    def estimate_qf(self, channel=0):
        """The IJG quality nearest the codec's current luma (0) or chroma table."""
        table = self._model.q_mtx_luma if channel == 0 else self._model.q_mtx_chroma
        return jpeg_qf_estimation(table, channel)

    def __repr__(self):
        if self._model is None:
            return f'JPEG(quality={self.quality},codec="{self.codec}")'
        return f'JPEG(quality={self.quality},codec="{self.codec}",trainable={self.trainable})'

    def summary(self, quality=None):
        return f'JPEG ({self.codec}) {self._quality_mode(quality)}'

    def summary_compact(self, quality=None):
        return self.summary(quality)

    @property
    def model_code(self):
        return f'JPEG-{self.codec}-{self._quality_mode()}'

    def _quality_mode(self, quality=None):
        quality = quality or self.quality
        if self._model is not None and self.trainable:
            return 'trainable QF~{}/{}'.format(
                jpeg_qf_estimation(self._model.q_mtx_luma, 0),
                jpeg_qf_estimation(self._model.q_mtx_chroma, 1))
        if _is_number(quality):
            return f'QF={quality}'
        if hasattr(quality, '__getitem__') and len(quality) == 2:
            return 'QF~[{},{}]'.format(*quality)
        if hasattr(quality, '__getitem__') and len(quality) > 2:
            return 'QF~{{{}}}'.format(','.join(str(x) for x in quality))
        return 'QF=?'
