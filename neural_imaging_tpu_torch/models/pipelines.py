"""
Camera ISP models (NIPs). Port of ``INetCore`` and ``INet`` of
``neural_imaging_tpu/models/pipelines.py``; UNet, DNet, ONet and ClassicISP
are not ported yet.

INet consumes RGGB Bayer stacks in [0,1] and emits RGB at twice the size,
clipped with a straight-through estimator.
"""
import numpy as np
import torch
from torch import nn

from neural_imaging_tpu_torch.models.base import TorchModel
from neural_imaging_tpu_torch.ops import ops
from neural_imaging_tpu_torch.ops.kernels import (EXAMPLE_SRGB, bilin_kernel, gamma_kernels,
                                                  upsampling_kernel)
from neural_imaging_tpu_torch.utils.paramspec import ParamSpec
from neural_imaging_tpu_torch.utils.utils import format_patch_shape

# INet's conv precisions → ops.conv2d's: 'exact' and 'exact_chw' are the
# reference's layouts of the float32 convolution; 'high' and 'default' round
# the operands as a matrix unit does (ops.at_precision)
CONV_PRECISIONS = {'exact': 'highest', 'exact_chw': 'highest', 'highest': 'highest',
                   'high': 'high', 'default': 'default'}


class INetCore(nn.Module):
    """Classic pipeline as a CNN: fixed 1x1 CFA upsampling → TF-order
    depth_to_space → reflect pad → demosaic conv → 1x1 sRGB → 2-layer tanh
    gamma net → straight-through clip. All but the upsampling kernel are
    parameters (unless ``trainable_upsampling``). Works on NCHW; each conv at
    ``precision`` ('highest' | 'high' | 'default', ``ops.conv2d``)."""

    def __init__(self, kernel=5, random_init=False, trainable_upsampling=False,
                 cfa_pattern='gbrg', precision='highest'):
        super().__init__()
        self.kernel = kernel
        self.precision = precision
        rng = np.random.RandomState(1234)
        upk = upsampling_kernel(cfa_pattern).reshape(1, 1, 4, 12)
        if random_init:
            dmf = rng.normal(0, 0.1, (kernel, kernel, 3, 3))
            g1k = rng.normal(0, 0.1, (1, 1, 3, 12))
            g1b = np.zeros(12)
            g2k = rng.normal(0, 0.1, (1, 1, 12, 3))
            g2b = np.zeros(3)
            srgbk = np.eye(3).reshape(1, 1, 3, 3)
        else:
            dmf = bilin_kernel(kernel)
            d1k, g1b, d2k, g2b = gamma_kernels()
            g1k, g2k = d1k.reshape(1, 1, 3, 12), d2k.reshape(1, 1, 12, 3)
            srgbk = EXAMPLE_SRGB.T.reshape(1, 1, 3, 3)

        if trainable_upsampling:
            self.upsampling = nn.Parameter(ops.hwio_to_oihw(upk))
        else:
            self.register_buffer('upsampling', ops.hwio_to_oihw(upk), persistent=False)
        self.demosaic = nn.Parameter(ops.hwio_to_oihw(dmf))
        self.srgb = nn.Parameter(ops.hwio_to_oihw(srgbk))
        self.gamma_d1_kernel = nn.Parameter(ops.hwio_to_oihw(g1k))
        self.gamma_d1_bias = nn.Parameter(torch.as_tensor(g1b, dtype=torch.float32))
        self.gamma_d2_kernel = nn.Parameter(ops.hwio_to_oihw(g2k))
        self.gamma_d2_bias = nn.Parameter(torch.as_tensor(g2b, dtype=torch.float32))

    def forward(self, x):
        """(N, 4, h, w) RAW stack → (N, 3, 2h, 2w) RGB in [0,1]."""
        def conv(t, k, padding='SAME'):
            return ops.conv2d(t, k, padding, precision=self.precision)

        bayer = ops.depth_to_space(conv(x, self.upsampling), 2)
        bayer = ops.pad2d(bayer, (self.kernel - 1) // 2, 'reflect')
        rgb = conv(bayer, self.demosaic, padding='VALID')
        srgb = conv(rgb, self.srgb)
        g = torch.tanh(conv(srgb, self.gamma_d1_kernel) + self.gamma_d1_bias[:, None, None])
        y = conv(g, self.gamma_d2_kernel) + self.gamma_d2_bias[:, None, None]
        return ops.st_clip(y)


class INet(TorchModel):
    """Neural replication of the classic pipeline steps."""

    def __init__(self, patch_size=None, random_init=False, kernel=5,
                 trainable_upsampling=False, cfa_pattern='gbrg', conv_precision='exact',
                 loss_metric='L2', device='cuda'):
        if loss_metric not in ops.LOSSES:
            raise ValueError(f'Unsupported loss metric {loss_metric!r}')
        if loss_metric == 'MS-SSIM':
            raise NotImplementedError('the MS-SSIM loss is not ported yet')
        if conv_precision not in CONV_PRECISIONS:
            raise ValueError(f'Unsupported conv precision {conv_precision!r}; use one of '
                             f'{list(CONV_PRECISIONS)}')
        if cfa_pattern.lower() not in ('gbrg', 'rggb', 'bggr'):
            raise ValueError(f'Unsupported CFA pattern {cfa_pattern!r}')
        self._h = ParamSpec({'random_init': (False, bool), 'kernel': (5, int),
                             'trainable_upsampling': (False, bool),
                             'cfa_pattern': ('gbrg', str), 'conv_precision': ('exact', str)})
        self._h.update(random_init=random_init, kernel=kernel,
                       trainable_upsampling=trainable_upsampling, cfa_pattern=cfa_pattern,
                       conv_precision=conv_precision)
        self.patch_size = patch_size
        self.in_channels = 4
        self.loss_metric = loss_metric
        super().__init__(INetCore(kernel=kernel, random_init=random_init,
                                  trainable_upsampling=trainable_upsampling,
                                  cfa_pattern=cfa_pattern,
                                  precision=CONV_PRECISIONS[conv_precision]), device)

    def loss(self, batch_y, batch_Y):
        """The fidelity loss ``ops.LOSSES[loss_metric]`` of the developed NHWC
        batch ``batch_Y`` against the target ``batch_y``."""
        return ops.LOSSES[self.loss_metric](batch_y, batch_Y)

    def process(self, batch_x):
        """Develop an NHWC RAW batch (N, h, w, 4) → NHWC RGB (N, 2h, 2w, 3)."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        with torch.no_grad():
            return self.module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def reset_performance_stats(self):
        self.performance = {
            'loss': {'training': [], 'validation': []},
            'psnr': {'validation': []},
            'ssim': {'validation': []},
        }

    def get_hyperparameters(self):
        return {'in_channels': self.in_channels, **self._h.to_json()}

    @property
    def patch_size_raw(self):
        return (self.patch_size, self.patch_size, self.in_channels)

    @property
    def patch_size_rgb(self):
        if self.patch_size is None:
            return None
        return (2 * self.patch_size, 2 * self.patch_size, 3)

    @property
    def model_code(self):
        return '{c}_{cfa}{tu}{r}_{k}x{k}'.format(
            c=self.class_name, cfa=self._h.cfa_pattern, k=self._h.kernel,
            tu='T' if self._h.trainable_upsampling else '',
            r='R' if self._h.random_init else '')

    def summary(self):
        return '{} : {} -> {}'.format(super().summary(), format_patch_shape(self.patch_size_raw),
                                      format_patch_shape(self.patch_size_rgb))
