"""
Core differentiable ops on NCHW tensors: convolutions with HWIO kernels,
TF-order depth_to_space, padding, pooling, the clipping straight-through
estimator and the activations. Port of the parts of
``neural_imaging_tpu/ops/ops.py`` that the manipulation-classification
forward path uses.

The reference's exact-f32 conv variants (``small_conv2d``, ``conv_chw``) are
TPU layouts of the same f32 convolution, so here they are all
:func:`conv2d`, with TF32 off (``utils.device.resolve_device``).
"""
import torch
import torch.nn.functional as F


def hwio_to_oihw(kernel):
    """HWIO kernel (the reference's layout, numpy) → contiguous float32 OIHW tensor."""
    return torch.tensor(kernel, dtype=torch.float32).permute(3, 2, 0, 1).contiguous()


def _same_pads(kh, kw):
    """(left, right, top, bottom) of TF 'SAME' padding at stride 1."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return pw, kw - 1 - pw, ph, kh - 1 - ph


def conv2d(x, weight, padding='SAME'):
    """Stride-1 f32 conv of NCHW ``x`` with an OIHW ``weight`` tensor.

    ``padding``: 'SAME' (TF semantics: zero padding, the extra pixel of an
    even kernel at the bottom/right) or 'VALID'."""
    if padding == 'SAME':
        x = F.pad(x, _same_pads(*weight.shape[-2:]))
    elif padding != 'VALID':
        raise ValueError(f'Unsupported padding {padding!r}')
    return F.conv2d(x, weight)


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


def st_clip(x, lo=0.0, hi=1.0):
    """Clip in the forward pass, identity gradient (the reference's exact form,
    so forward values match it to the bit)."""
    return (torch.clamp(x, lo, hi) - x).detach() + x


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
