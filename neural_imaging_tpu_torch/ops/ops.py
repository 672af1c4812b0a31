"""
Core differentiable ops on NCHW tensors: convolutions with HWIO kernels,
TF-order depth_to_space, padding, pooling, the clipping straight-through
estimator, the activations, batch normalization to float, the L2 loss and
the NIP's image losses (``LOSSES``). Port of the parts of
``neural_imaging_tpu/ops/ops.py`` that the manipulation-classification path
and the DCN use.

The reference's exact-f32 conv variants (``small_conv2d``, ``conv_chw``) are
TPU layouts of the same f32 convolution, so here they are all
:func:`conv2d`, with TF32 off (``utils.device.resolve_device``).
"""
import functools

import torch
import torch.nn.functional as F

from neural_imaging_tpu_torch.ops import ssim as ssim_ops


def hwio_to_oihw(kernel):
    """HWIO kernel (the reference's layout, numpy) → contiguous float32 OIHW tensor."""
    return torch.tensor(kernel, dtype=torch.float32).permute(3, 2, 0, 1).contiguous()


def _same_pads(size, k, stride):
    """(low, high) zero padding of TF 'SAME' along one axis: the output has
    ceil(size / stride) samples, and an odd total puts the extra pixel at the
    bottom/right (so a 5-tap kernel at stride 2 on an even size pads (1, 2))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, padding='SAME', stride=1, bias=None):
    """f32 conv of NCHW ``x`` with an OIHW ``weight`` tensor (and an optional
    per-channel ``bias``).

    ``padding``: 'SAME' (TF semantics at any stride: zero padding, the extra
    pixel at the bottom/right) or 'VALID'."""
    if padding == 'SAME':
        top, bottom = _same_pads(x.shape[-2], weight.shape[-2], stride)
        left, right = _same_pads(x.shape[-1], weight.shape[-1], stride)
        x = F.pad(x, (left, right, top, bottom))
    elif padding != 'VALID':
        raise ValueError(f'Unsupported padding {padding!r}')
    return F.conv2d(x, weight, bias, stride)


def depthwise_conv2d(x, k2d, pad_mode='reflect'):
    """Depthwise spatial filter of an NCHW batch, padded 'SAME' with ``pad_mode``.

    ``k2d``: (kh, kw) shared across channels or (kh, kw, C) per channel."""
    c = x.shape[1]
    k = torch.as_tensor(k2d, dtype=x.dtype, device=x.device)
    if k.ndim == 2:
        k = k[:, :, None].expand(-1, -1, c)
    kh, kw = k.shape[:2]
    if kh != kw:
        raise NotImplementedError('depthwise_conv2d expects a square kernel')
    xp = pad2d(x, (kh - 1) // 2, pad_mode)
    return F.conv2d(xp, k.permute(2, 0, 1)[:, None], groups=c)


def depth_to_space(x, block=2):
    """TF-order depth_to_space on NCHW: channel (i*block+j)*C + c → subpixel (i, j).

    ``F.pixel_shuffle`` reads channel c*block² + i*block + j instead."""
    n, c, h, w = x.shape
    cc = c // (block * block)
    x = x.reshape(n, block, block, cc, h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)                    # (n, cc, h, bi, w, bj)
    return x.reshape(n, cc, h * block, w * block)


def pad2d(x, pad, mode='reflect'):
    """Spatial padding of an NCHW tensor. mode: 'reflect' | 'symmetric' | 'constant'.

    'symmetric' (edge repeated, numpy's mode) has no ``F.pad`` mode and is
    built from flipped edge strips."""
    if pad == 0:
        return x
    if mode in ('reflect', 'constant'):
        return F.pad(x, (pad, pad, pad, pad), mode=mode)
    if mode != 'symmetric':
        raise ValueError(f'Unsupported padding mode {mode!r}')
    x = torch.cat([x[..., :pad, :].flip(-2), x, x[..., -pad:, :].flip(-2)], dim=-2)
    return torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)], dim=-1)


def avg_pool(x, factor):
    """Average pooling with window = stride = factor (NCHW, sizes divisible by it)."""
    if x.shape[-2] % factor or x.shape[-1] % factor:
        raise ValueError(f'avg_pool: {tuple(x.shape[-2:])} is not divisible by {factor}')
    return F.avg_pool2d(x, factor)


def max_pool(x, window=2):
    """Max pooling with window = stride, 'VALID' (NCHW)."""
    return F.max_pool2d(x, window, window)


def global_average_pool(x):
    """Mean over the spatial axes of an NCHW tensor → (N, C)."""
    return x.mean(dim=(-2, -1))


@functools.lru_cache()
def _bound(value, dtype, device):
    return torch.full((), value, dtype=dtype, device=device)


def clip(x, lo, hi):
    """Clip to [lo, hi] with ``jnp.clip``'s gradient: 1 inside, 0 outside and
    1/2 at a bound, where ``torch.clamp`` passes 1 (``torch.maximum`` and
    ``torch.minimum`` split a tie's gradient as jax does). Saturated images
    and probabilities sit exactly at a bound."""
    return torch.minimum(torch.maximum(x, _bound(lo, x.dtype, x.device)),
                         _bound(hi, x.dtype, x.device))


def st_clip(x, lo=0.0, hi=1.0):
    """Clip in the forward pass, identity gradient (the reference's exact form,
    so forward values match it to the bit)."""
    return (torch.clamp(x, lo, hi) - x).detach() + x


def normalize_batch(x):
    """uint8 / uint16 batches → float32 in [0, 1] (÷ 255, ÷ 65535, the same f32
    divide as the reference, by a divisor on x's device: CUDA multiplies by
    the reciprocal of a Python scalar divisor); float batches are cast to
    float32. uint16 is widened through int32, which every device converts."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / torch.full((), 255.0, device=x.device)
    if x.dtype == torch.uint16:
        wide = x.view(torch.int16).to(torch.int32) & 0xFFFF
        return wide.to(torch.float32) / torch.full((), 65535.0, device=x.device)
    return x.to(torch.float32)


def l2_loss(x):
    """0.5 * sum(x**2), the DCN objective's ``tf.nn.l2_loss`` convention."""
    return 0.5 * torch.sum(torch.square(x))


def mse(a, b):
    """Mean squared error of two images in [0, 1], on the 0-255 scale."""
    return torch.mean((255.0 * a - 255.0 * b) ** 2)


def mae(a, b):
    """Mean absolute error of two images in [0, 1], on the 0-255 scale."""
    return torch.mean(torch.abs(255.0 * a - 255.0 * b))


def ssim_loss(a, b):
    """255 (1 - SSIM), averaged over the NHWC batches a and b."""
    return torch.mean(255.0 * (1.0 - ssim_ops.ssim(a, b, max_val=1.0)))


def msssim_loss(a, b):
    raise NotImplementedError('the MS-SSIM loss needs ssim.ms_ssim, which is not ported yet')


# the NIP's fidelity losses by name; each takes (target, output), NHWC
LOSSES = {'L2': mse, 'L1': mae, 'SSIM': ssim_loss, 'MS-SSIM': msssim_loss}


def leaky_relu(x):
    """Leaky ReLU with the reference's slope of 0.2 (torch defaults to 0.01)."""
    return F.leaky_relu(x, negative_slope=0.2)


ACTIVATIONS = {
    'leaky_relu': leaky_relu,
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'softsign': F.softsign,
}
