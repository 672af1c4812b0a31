"""
Differentiable SSIM (``tf.image.ssim`` parity: 11x11 Gaussian window with
sigma 1.5, k1 = 0.01, k2 = 0.03). Port of ``ssim_per_channel`` and ``ssim``
of ``neural_imaging_tpu/ops/ssim.py``; ``ms_ssim`` is not ported yet.

The public functions take NHWC batches, as the reference's do. The window
filter is a depthwise 'VALID' float32 convolution; the reference runs it at
HIGHEST precision, so TF32 stays off (``utils.device.resolve_device``).
"""
import torch
import torch.nn.functional as F


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
