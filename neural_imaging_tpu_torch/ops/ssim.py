"""
Differentiable SSIM (``tf.image.ssim`` parity: 11x11 Gaussian window with
sigma 1.5, k1 = 0.01, k2 = 0.03) and multi-scale SSIM. Port of
``ssim_per_channel``, ``ssim``, ``_downsample2`` and ``ms_ssim`` of
``neural_imaging_tpu/ops/ssim.py``.

The public functions take NHWC batches, as the reference's do. The window
filter is a depthwise 'VALID' float32 convolution; the reference runs it at
HIGHEST precision, so TF32 stays off (``utils.device.resolve_device``).
"""
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size, sigma, dtype, device):
    coords = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (coords / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(x, window):
    """Depthwise 'VALID' convolution of NCHW x with a 2-D window."""
    c = x.shape[1]
    return F.conv2d(x, window[None, None].expand(c, 1, *window.shape), groups=c)


def ssim_per_channel(a, b, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """(mean of luminance·cs, mean of cs) per image and channel of NHWC
    batches a and b, each shape (N, C)."""
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    window = _gaussian_window(filter_size, filter_sigma, a.dtype, a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    mu_a = _filter2d(a, window)
    mu_b = _filter2d(b, window)
    mu_aa = _filter2d(a * a, window)
    mu_bb = _filter2d(b * b, window)
    mu_ab = _filter2d(a * b, window)

    sigma_aa = mu_aa - mu_a * mu_a
    sigma_bb = mu_bb - mu_b * mu_b
    sigma_ab = mu_ab - mu_a * mu_b

    luminance = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return torch.mean(luminance * cs, dim=(2, 3)), torch.mean(cs, dim=(2, 3))


def ssim(a, b, max_val=1.0, **kwargs):
    """Per-image SSIM of NHWC batches, shape (N,): the mean over channels."""
    ssim_val, _ = ssim_per_channel(a, b, max_val, **kwargs)
    return torch.mean(ssim_val, dim=-1)


def _downsample2(x):
    """2x2 average pooling of an NHWC batch, an odd side first padded by
    repeating its last row or column (the MS-SSIM pyramid step). The four
    taps are summed in row-major order, as jax's ``reduce_window`` sums them."""
    pad_h, pad_w = x.shape[1] % 2, x.shape[2] % 2
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode='replicate')
        x = x.permute(0, 2, 3, 1)
    out = x[:, 0::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 0::2] + x[:, 1::2, 1::2]
    return out / 4.0


def ms_ssim(a, b, max_val=1.0, power_factors=_MSSSIM_WEIGHTS, filter_size=11):
    """Multi-scale SSIM of each image of NHWC batches, shape (N,). The
    pyramid stops where a side falls below ``filter_size``, and the weights
    are then cut as the reference cuts them (``power_factors[:level]``,
    ``mcs[:max(level - 1, 0)]``): at 128 px four scales remain."""
    levels = len(power_factors)
    mcs = []
    ssim_val = None
    for level in range(levels):
        if min(a.shape[1], a.shape[2]) < filter_size:
            power_factors = power_factors[:level]
            mcs = mcs[:max(level - 1, 0)]
            break
        ssim_l, cs_l = ssim_per_channel(a, b, max_val, filter_size=filter_size)
        ssim_val = torch.mean(ssim_l, dim=-1)
        if level < levels - 1:
            mcs.append(torch.mean(torch.relu(cs_l), dim=-1))
            a, b = _downsample2(a), _downsample2(b)

    result = torch.relu(ssim_val) ** power_factors[-1]
    for cs_l, w in zip(mcs, power_factors[:-1]):
        result = result * (cs_l ** w)
    return result
