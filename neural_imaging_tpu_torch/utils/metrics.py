"""
Image quality metrics of the validation (on the host, in float64): copy of
``neural_imaging_tpu/utils/metrics.py``. ``ssim`` is skimage's
``structural_similarity`` with its defaults (uniform 7x7 window, sample
covariance, border crop, mean over channels), without skimage.
"""
import numpy as np
from scipy.ndimage import uniform_filter


def _ssim_single_channel(a, b, data_range=1.0, win_size=7, k1=0.01, k2=0.03):
    if min(a.shape[:2]) < win_size:
        raise ValueError(f'Image is smaller than the SSIM window ({win_size})')
    a = a.astype(np.float64)
    b = b.astype(np.float64)

    ndim = a.ndim
    NP = win_size ** ndim
    cov_norm = NP / (NP - 1.0)  # sample covariance, skimage default

    filt = lambda x: uniform_filter(x, size=win_size)
    ux, uy = filt(a), filt(b)
    uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1, a2 = 2.0 * ux * uy + c1, 2.0 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, dim - pad) for dim in s.shape)
    return float(s[crop].mean())


def _squeeze_single(x):
    x = np.asarray(x)
    if x.ndim == 4 and x.shape[0] == 1:
        return x[0]
    return x


def ssim(a, b, data_range=1.0):
    """Structural similarity of (h, w, 3) or (h, w) images, or per image of
    two 4-D batches."""
    a, b = _squeeze_single(a), _squeeze_single(b)
    if a.ndim in (2, 3) and b.ndim == a.ndim:
        if a.ndim == 2:
            return _ssim_single_channel(a, b, data_range)
        return float(np.mean([_ssim_single_channel(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    if a.ndim == 4 and b.ndim == 4:
        return np.array([ssim(a[i], b[i], data_range) for i in range(a.shape[0])])
    raise ValueError(f'Incompatible tensor shapes! {a.shape} and {b.shape}')


def psnr(a, b, data_range=1.0):
    """Peak signal-to-noise ratio (dB)."""
    a, b = _squeeze_single(a), _squeeze_single(b)
    if a.ndim in (2, 3) and b.ndim == a.ndim:
        err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        if err == 0:
            return float('inf')
        return float(10.0 * np.log10((data_range ** 2) / err))
    if a.ndim == 4 and b.ndim == 4:
        return np.array([psnr(a[i], b[i], data_range) for i in range(a.shape[0])])
    raise ValueError(f'Incompatible tensor shapes! {a.shape} and {b.shape}')


def mse(a, b):
    a, b = _squeeze_single(a), _squeeze_single(b)
    if a.ndim in (2, 3) and b.ndim == a.ndim:
        return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if a.ndim == 4 and b.ndim == 4:
        return np.array([mse(a[i], b[i]) for i in range(a.shape[0])])
    raise ValueError(f'Incompatible tensor shapes! {a.shape} and {b.shape}')


def mae(a, b):
    a, b = _squeeze_single(a), _squeeze_single(b)
    if a.ndim in (2, 3) and b.ndim == a.ndim:
        return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))
    if a.ndim == 4 and b.ndim == 4:
        return np.array([mae(a[i], b[i]) for i in range(a.shape[0])])
    raise ValueError(f'Incompatible tensor shapes! {a.shape} and {b.shape}')


def batch(a, b, metric=ssim):
    """Mean of ``metric`` over the images of two (n, h, w, c) batches."""
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(f'Expected 4-D batches (n, h, w, c), got {a.shape} and {b.shape}')
    if len(a) != len(b):
        raise ValueError(f'Image batches must be of the same length: {len(a)} and {len(b)}')
    return float(np.mean([metric(a[i], b[i]) for i in range(len(a))]))
