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

# The reference's conv precisions that are plain f32 convolutions. Its 'high'
# and 'default' are bf16 matrix-unit paths, not ported yet.
F32_CONV_PRECISIONS = ('exact', 'exact_chw', 'highest')


class INetCore(nn.Module):
    """Classic pipeline as a CNN: fixed 1x1 CFA upsampling → TF-order
    depth_to_space → reflect pad → demosaic conv → 1x1 sRGB → 2-layer tanh
    gamma net → straight-through clip. All but the upsampling kernel are
    parameters (unless ``trainable_upsampling``). Works on NCHW."""

    def __init__(self, kernel=5, random_init=False, trainable_upsampling=False,
                 cfa_pattern='gbrg'):
        super().__init__()
        self.kernel = kernel
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
        bayer = ops.depth_to_space(ops.conv2d(x, self.upsampling), 2)
        bayer = ops.pad2d(bayer, (self.kernel - 1) // 2, 'reflect')
        rgb = ops.conv2d(bayer, self.demosaic, padding='VALID')
        srgb = ops.conv2d(rgb, self.srgb)
        g = torch.tanh(ops.conv2d(srgb, self.gamma_d1_kernel)
                       + self.gamma_d1_bias[:, None, None])
        y = ops.conv2d(g, self.gamma_d2_kernel) + self.gamma_d2_bias[:, None, None]
        return ops.st_clip(y)


class INet(TorchModel):
    """Neural replication of the classic pipeline steps."""

    def __init__(self, patch_size=None, random_init=False, kernel=5,
                 trainable_upsampling=False, cfa_pattern='gbrg', conv_precision='exact',
                 device='cuda'):
        if conv_precision not in F32_CONV_PRECISIONS:
            raise NotImplementedError(f'INet conv_precision={conv_precision!r} is a bf16 '
                                      f'path, not ported; use one of {F32_CONV_PRECISIONS}')
        if cfa_pattern.lower() not in ('gbrg', 'rggb', 'bggr'):
            raise ValueError(f'Unsupported CFA pattern {cfa_pattern!r}')
        self.patch_size = patch_size
        super().__init__(INetCore(kernel=kernel, random_init=random_init,
                                  trainable_upsampling=trainable_upsampling,
                                  cfa_pattern=cfa_pattern), device)

    def process(self, batch_x):
        """Develop an NHWC RAW batch (N, h, w, 4) → NHWC RGB (N, 2h, 2w, 3)."""
        x = torch.as_tensor(batch_x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        with torch.no_grad():
            return self.module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
