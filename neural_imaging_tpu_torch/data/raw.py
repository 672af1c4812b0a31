"""
Development of a Bayer mosaic into RGB on the host, for the fixtures: copy of
the bilinear path of ``neural_imaging_tpu/data/raw.py`` (``_cfa_masks``,
``demosaic_bilinear``, ``_conv2``, ``develop_mosaic``). The reference's
Malvar and Menon demosaicing are not ported and raise.
"""
import numpy as np
from scipy.ndimage import convolve

from neural_imaging_tpu_torch.data import bayer


def _conv2(x, k):
    return convolve(x, k, mode='mirror')


def _cfa_masks(shape, cfa_pattern):
    """Sampling masks (R, G, B), float64 0/1, of a CFA pattern over a (h, w) grid."""
    off = bayer.CFA_OFFSETS[cfa_pattern.upper()]
    masks = [np.zeros(shape, dtype=np.float64) for _ in range(3)]
    for plane in bayer.STACK_PLANES:
        r, c = off[plane]
        masks[bayer.PLANE_RGB[plane]][r::2, c::2] = 1
    return masks


def demosaic_bilinear(mosaic, cfa_pattern):
    """Bilinear demosaic of a single-channel Bayer mosaic into (h, w, 3) RGB."""
    masks = _cfa_masks(mosaic.shape, cfa_pattern)
    g_kernel = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float64) / 4
    rb_kernel = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64) / 4
    out = np.zeros((*mosaic.shape, 3), dtype=np.float64)
    out[..., 0] = _conv2(mosaic * masks[0], rb_kernel)
    out[..., 1] = _conv2(mosaic * masks[1], g_kernel)
    out[..., 2] = _conv2(mosaic * masks[2], rb_kernel)
    return out


def develop_mosaic(mosaic, cfa_pattern, cam2srgb=None, brightness=None, use_gamma=True,
                   demosaicing='bilinear'):
    """Develop a normalized [0, 1] mosaic: demosaic, camera → sRGB, optional
    brightness normalization ('percentile' or 'shift'), gamma 1/2.2."""
    if demosaicing != 'bilinear':
        raise NotImplementedError(f'{demosaicing!r} demosaicing is not ported (ROADMAP.md §1 '
                                  'item 6); use bilinear')
    rgb = np.clip(demosaic_bilinear(mosaic.astype(np.float64), cfa_pattern), 0, 1)

    if cam2srgb is not None:
        rgb = np.einsum('ij,hwj->hwi', np.asarray(cam2srgb, dtype=np.float64), rgb)
        rgb = np.clip(rgb, 0, 1)

    if brightness == 'percentile':
        percentile = 0.5
        rgb = rgb - np.percentile(rgb, percentile)
        rgb = rgb / max(np.percentile(rgb, 100 - percentile), 1e-9)
    elif brightness == 'shift':
        rgb = rgb * (0.25 / max(np.mean(rgb), 1e-9))

    rgb = np.clip(rgb, 0, 1)
    if use_gamma:
        rgb = np.power(rgb, 1 / 2.2)
    return rgb
