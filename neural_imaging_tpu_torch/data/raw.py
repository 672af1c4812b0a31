"""
RAW ingestion and development: a port of ``neural_imaging_tpu/data/raw.py``
without its rawpy branches.

- Reading (host, numpy): ``unpack`` gives a camera file's (or a synthetic
  ``*.nraw.npz`` container's) normalized, white-balanced mosaic or RGGB stack
  with its CFA, camera→sRGB matrix and multipliers. Camera files are parsed
  by the port's own readers: ``.dng`` (``data/dng.py``), ``.cr2``, ``.nef``
  and ``.arw`` (``data/camera_raw.py``).
- Development (PyTorch float64, on ``device``, the card unless the caller
  asks for the CPU): ``develop`` and ``process`` run demosaic → camera →
  sRGB → brightness → gamma 1/2.2 with the bilinear, Malvar-He-Cutler or
  Menon (``data/menon.py``) demosaicer. The filters sum in scipy.ndimage's
  order (``convolve``), and the percentiles interpolate as numpy's, so on the
  CPU the result is the reference's up to the last bits of its einsum, mean
  and power.
- The host numpy bilinear path (``demosaic_bilinear``, ``develop_mosaic``)
  is a copy of the reference's, which the procedural fixtures develop with
  byte for byte.

Synthetic RAW container (``*.nraw.npz``): mosaic (uint16 h×w), black,
saturation, cam_mul (4,), cfa (str), cam2srgb (3×3).
"""
import math
import os

import numpy as np
import torch
from scipy.ndimage import convolve as _scipy_convolve

from neural_imaging_tpu_torch.data import bayer
from neural_imaging_tpu_torch.utils.device import resolve_device

BRIGHTNESS = ('percentile', 'shift', None)
PERCENTILE = 0.5          # the 'percentile' brightness clips this much at each end


# ---------------------------------------------------------------------------------
# Host development (numpy): the fixtures' bilinear path
# ---------------------------------------------------------------------------------

def _conv2(x, k):
    return _scipy_convolve(x, k, mode='mirror')


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
    """Develop a normalized [0, 1] numpy mosaic on the host: demosaic, camera →
    sRGB, optional brightness normalization ('percentile' or 'shift'), gamma
    1/2.2. Bilinear runs in numpy, as the reference; Malvar and Menon through
    ``develop`` on the CPU."""
    if demosaicing != 'bilinear':
        return develop(torch.from_numpy(np.asarray(mosaic, dtype=np.float64)), cfa_pattern,
                       cam2srgb, brightness=brightness, use_gamma=use_gamma,
                       demosaicing=demosaicing, device='cpu').numpy()
    rgb = np.clip(demosaic_bilinear(mosaic.astype(np.float64), cfa_pattern), 0, 1)

    if cam2srgb is not None:
        rgb = np.einsum('ij,hwj->hwi', np.asarray(cam2srgb, dtype=np.float64), rgb)
        rgb = np.clip(rgb, 0, 1)

    if brightness == 'percentile':
        rgb = rgb - np.percentile(rgb, PERCENTILE)
        rgb = rgb / max(np.percentile(rgb, 100 - PERCENTILE), 1e-9)
    elif brightness == 'shift':
        rgb = rgb * (0.25 / max(np.mean(rgb), 1e-9))

    rgb = np.clip(rgb, 0, 1)
    if use_gamma:
        rgb = np.power(rgb, 1 / 2.2)
    return rgb


# ---------------------------------------------------------------------------------
# Device development (PyTorch float64)
# ---------------------------------------------------------------------------------

def _mirror_index(n, pad, device):
    """Indices of scipy.ndimage's 'mirror' extension (d c b | a b c d | c b a)
    of an axis of length n by ``pad`` on each side."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def convolve(x, k):
    """``scipy.ndimage.convolve(x, k, mode='mirror')`` of a float64 (h, w)
    tensor with an odd-sized kernel, summed in scipy's order: the flipped
    kernel's non-zero taps in row-major order, each ``tap * x`` added to a
    running sum that starts at 0."""
    k = np.asarray(k, dtype=np.float64)[::-1, ::-1]
    kh, kw = k.shape
    ch, cw = kh // 2, kw // 2
    h, w = x.shape
    xp = x.index_select(0, _mirror_index(h, ch, x.device)).index_select(
        1, _mirror_index(w, cw, x.device))
    out = None
    for a in range(kh):
        for b in range(kw):
            if abs(k[a, b]) > np.finfo(np.float64).eps:
                term = xp[a:a + h, b:b + w] * float(k[a, b])
                out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(x)


def convolve1d(x, weights, axis):
    """``scipy.ndimage.convolve1d(x, weights, axis, mode='mirror')`` of a
    float64 (h, w) tensor with odd, symmetric weights, in scipy's order for
    symmetric filters: the centre tap's product, then for each distance d
    from the largest down, (x[-d] + x[+d]) times its tap."""
    w = np.asarray(weights, dtype=np.float64)
    c = len(w) // 2
    if len(w) % 2 == 0 or not np.allclose(w, w[::-1], rtol=0, atol=np.finfo(np.float64).eps):
        raise ValueError('convolve1d takes odd, symmetric weights')
    n = x.shape[axis]
    xp = x.index_select(axis, _mirror_index(n, c, x.device))

    def tap(offset):
        return xp.narrow(axis, c + offset, n)

    out = tap(0) * float(w[c])
    for d in range(c, 0, -1):
        out = out + (tap(-d) + tap(d)) * float(w[c - d])
    return out


def cfa_masks(shape, cfa_pattern, device):
    """Boolean sampling masks (R, G, B) of a CFA pattern over a (h, w) grid."""
    off = bayer.CFA_OFFSETS[cfa_pattern.upper()]
    masks = [torch.zeros(shape, dtype=torch.bool, device=device) for _ in range(3)]
    for plane in bayer.STACK_PLANES:
        r, c = off[plane]
        masks[bayer.PLANE_RGB[plane]][r::2, c::2] = True
    return masks


def demosaic_bilinear_torch(mosaic, cfa_pattern):
    """Bilinear demosaic of a (h, w) float64 tensor into (h, w, 3) RGB."""
    m = mosaic.to(torch.float64)
    masks = cfa_masks(m.shape, cfa_pattern, m.device)
    g_kernel = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float64) / 4
    rb_kernel = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64) / 4
    return torch.stack([convolve(m * masks[0], rb_kernel), convolve(m * masks[1], g_kernel),
                        convolve(m * masks[2], rb_kernel)], dim=-1)


# Malvar-He-Cutler (2004) filters
_GR_GB = np.array([
    [0, 0, -1, 0, 0],
    [0, 0, 2, 0, 0],
    [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0],
    [0, 0, -1, 0, 0]]) / 8
_RG_RB_BG_BR = np.array([
    [0, 0, 0.5, 0, 0],
    [0, -1, 0, -1, 0],
    [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0],
    [0, 0, 0.5, 0, 0]]) / 8
_RG_BR_BG_RB = _RG_RB_BG_BR.T
_RB_BB_BR_RR = np.array([
    [0, 0, -1.5, 0, 0],
    [0, 2, 0, 2, 0],
    [-1.5, 0, 6, 0, -1.5],
    [0, 2, 0, 2, 0],
    [0, 0, -1.5, 0, 0]]) / 8


def demosaic_malvar(mosaic, cfa_pattern):
    """Malvar-He-Cutler (2004) high-quality linear demosaicing of a (h, w)
    tensor into (h, w, 3) RGB, float64."""
    m = mosaic.to(torch.float64)
    R_m, G_m, B_m = cfa_masks(m.shape, cfa_pattern, m.device)

    R = m * R_m
    G = m * G_m
    B = m * B_m
    G = torch.where(R_m | B_m, convolve(m, _GR_GB), G)

    RBg_RBBR = convolve(m, _RG_RB_BG_BR)
    RBg_BRRB = convolve(m, _RG_BR_BG_RB)
    RBgr_BBRR = convolve(m, _RB_BB_BR_RR)

    # row/column phase masks
    R_r = R_m.any(dim=1, keepdim=True)
    R_c = R_m.any(dim=0, keepdim=True)
    B_r = B_m.any(dim=1, keepdim=True)
    B_c = B_m.any(dim=0, keepdim=True)

    R = torch.where(R_r & B_c, RBg_RBBR, R)
    R = torch.where(B_r & R_c, RBg_BRRB, R)
    B = torch.where(B_r & R_c, RBg_RBBR, B)
    B = torch.where(R_r & B_c, RBg_BRRB, B)
    R = torch.where(B_r & B_c, RBgr_BBRR, R)
    B = torch.where(R_r & R_c, RBgr_BBRR, B)
    return torch.stack([R, G, B], dim=-1)


def _demosaic_menon(mosaic, cfa_pattern):
    from neural_imaging_tpu_torch.data.menon import demosaic_menon
    return demosaic_menon(mosaic, cfa_pattern, refine=True)


DEMOSAICERS = {
    'bilinear': demosaic_bilinear_torch,
    'malvar': demosaic_malvar,
    'menon': _demosaic_menon,  # DDFAPD, the reference's default class
}


def _lerp(a, b, t):
    """numpy's linear interpolation of two order statistics (``_lerp``)."""
    diff = b - a
    if t >= 0.5:
        return b - diff * (1 - t)
    return a + diff * t


def percentile(x, q, sorted_values=None):
    """``np.percentile(x, q)`` (method 'linear') over all elements of a
    tensor, as a 0-d tensor on its device. ``torch.quantile`` refuses more
    than 2^24 elements; this takes the two order statistics from a sort
    (``sorted_values``, the sorted flattened ``x``, where the caller has
    it) and interpolates as numpy does."""
    s = sorted_values if sorted_values is not None else torch.sort(x.reshape(-1)).values
    n = s.numel()
    virtual = (n - 1) * (q / 100)
    if virtual >= n - 1:
        return s[-1]
    if virtual < 0:
        return s[0]
    lo = math.floor(virtual)
    return _lerp(s[lo], s[lo + 1], virtual - lo)


def _to_srgb(rgb, cam2srgb):
    """``np.einsum('ij,hwj->hwi', cam2srgb, rgb)`` in numpy's order of the
    sum over j: (j=0 + j=2) + j=1."""
    m = np.asarray(cam2srgb, dtype=np.float64)
    r, g, b = rgb.unbind(-1)
    return torch.stack([(r * float(m[i, 0]) + b * float(m[i, 2])) + g * float(m[i, 1])
                        for i in range(3)], dim=-1)


def develop(mosaic, cfa_pattern, cam2srgb=None, brightness=None, use_gamma=True,
            demosaicing='bilinear', device='cuda'):
    """Develop a normalized [0, 1] (h, w) mosaic (numpy array or tensor) on
    ``device`` in float64: demosaic, clip, camera → sRGB, clip, brightness
    ('percentile': shift the 0.5th percentile to 0 and scale the 99.5th of
    the result to 1; 'shift': scale the mean to 0.25), clip, gamma 1/2.2.
    Returns an (h, w, 3) float64 tensor on ``device``."""
    if brightness not in BRIGHTNESS:
        raise ValueError('Unsupported brightness correction mode!')
    if demosaicing not in DEMOSAICERS:
        raise ValueError('Unsupported demosaicing method!')
    dev = resolve_device(device)
    m = torch.as_tensor(mosaic).to(device=dev, dtype=torch.float64)
    rgb = DEMOSAICERS[demosaicing](m, cfa_pattern).clamp_(0, 1)

    if cam2srgb is not None:
        rgb = _to_srgb(rgb, cam2srgb).clamp_(0, 1)

    if brightness == 'percentile':
        s = torch.sort(rgb.reshape(-1)).values
        low = percentile(None, PERCENTILE, sorted_values=s)
        rgb = rgb - low
        high = percentile(None, 100 - PERCENTILE, sorted_values=s - low)
        rgb = rgb / torch.clamp(high, min=1e-9)
    elif brightness == 'shift':
        mean = torch.clamp(rgb.mean(), min=1e-9)
        rgb = rgb * (torch.full_like(mean, 0.25) / mean)

    rgb = rgb.clamp_(0, 1)
    if use_gamma:
        rgb = torch.pow(rgb, 1 / 2.2)
    return rgb


def to_uint8(rgb):
    """A developed [0, 1] tensor → uint8 numpy on the host, rounded half to
    even as the reference's ``(255 * rgb).round().astype(np.uint8)``."""
    return (255 * rgb).round_().to(torch.uint8).cpu().numpy()


# ---------------------------------------------------------------------------------
# Reading (host, numpy)
# ---------------------------------------------------------------------------------

def save_nraw(filename, mosaic_u16, cfa_pattern='GBRG', black=0, saturation=2 ** 16 - 1,
              cam_mul=(1.0, 1.0, 1.0, 1.0), cam2srgb=None):
    """Write a synthetic RAW container (``*.nraw.npz``)."""
    if cam2srgb is None:
        cam2srgb = np.eye(3)
    np.savez_compressed(filename, mosaic=mosaic_u16.astype(np.uint16),
                        black=np.uint32(black), saturation=np.uint32(saturation),
                        cam_mul=np.asarray(cam_mul, dtype=np.float32),
                        cfa=np.bytes_(cfa_pattern.upper().encode()),
                        cam2srgb=np.asarray(cam2srgb, dtype=np.float64))


def _load_raw_data(filename):
    """(mosaic float32 [0, 1] before white balance, cfa, cam2srgb, cam_mul)
    of a camera file or a ``.npz`` container."""
    if filename.endswith('.npz'):
        z = np.load(filename)
        mosaic = z['mosaic'].astype(np.float32)
        black, saturation = float(z['black']), float(z['saturation'])
        mosaic = np.clip((mosaic - black) / (saturation - black), 0, 1)
        cfa = bytes(z['cfa']).decode() if z['cfa'].dtype.kind == 'S' else str(z['cfa'])
        return mosaic, cfa, np.asarray(z['cam2srgb']), np.asarray(z['cam_mul'], dtype=np.float32)

    ext = os.path.splitext(filename)[1].lower()
    if ext == '.dng':
        from neural_imaging_tpu_torch.data import dng
        return _normalize_parsed(dng.read_dng(filename))
    if ext in ('.cr2', '.nef', '.arw'):
        from neural_imaging_tpu_torch.data import camera_raw
        return _normalize_parsed(camera_raw.read_camera_raw(filename))
    raise ValueError(f'{filename}: not a RAW file the port reads (.dng, .cr2, .nef, .arw or '
                     'a .npz container); the reference reads other formats through rawpy')


def _normalize_parsed(d):
    """(mosaic [0,1], cfa, cam2srgb, cam_mul) from a parsed dng/camera_raw dict."""
    mosaic = d['mosaic'].astype(np.float32)
    mosaic = np.clip((mosaic - d['black']) / (d['white'] - d['black']), 0, 1)
    cam_mul = np.asarray(d['cam_mul'][:4], dtype=np.float32)
    return mosaic, d['cfa_pattern'], d['cam2srgb'], cam_mul


def _apply_wb(mosaic, cfa_pattern, cam_mul):
    """White-balance R and B sites in place (G multiplier normalized to 1)."""
    cam_mul = np.asarray(cam_mul, dtype=np.float32).copy()
    if cam_mul[1] == 0:
        cam_mul[1] = 1
    cam_mul /= cam_mul[1]
    off = bayer.CFA_OFFSETS[cfa_pattern.upper()]
    r, c = off['R']
    mosaic[r::2, c::2] *= cam_mul[0]
    r, c = off['B']
    mosaic[r::2, c::2] *= cam_mul[2]
    return np.clip(mosaic, 0, 1)


def unpack(filename, stack=True, use_wb=True, expand=False):
    """Read a RAW image → normalized float32 mosaic (or (h/2, w/2, 4) RGGB
    stack) + (cfa, cam2srgb, cam_mul), numpy on the host."""
    mosaic, cfa, cam2srgb, cam_mul = _load_raw_data(filename)
    if use_wb:
        mosaic = _apply_wb(mosaic, cfa, cam_mul)
    if stack:
        # the reference masks the mosaic into a sparse RGB image and samples
        # that (bayer.stack_bayer); sampling the mosaic gives the same values
        off = bayer._offsets(cfa)
        image = np.stack([mosaic[off[p][0]::2, off[p][1]::2] for p in bayer.STACK_PLANES],
                         axis=-1).clip(0, 1)
    else:
        image = mosaic
    if expand:
        image = image[None]
    return image, cfa, cam2srgb, cam_mul


def process(filename, use_srgb=True, use_gamma=True, brightness='percentile',
            demosaicing='bilinear', expand=False, device='cuda'):
    """Develop a RAW file: read, normalize and white-balance on the host, then
    ``develop`` on ``device``. Returns an (h, w, 3) float64 tensor there
    ((1, h, w, 3) with ``expand``)."""
    if brightness not in BRIGHTNESS:
        raise ValueError('Unsupported brightness correction mode!')
    if demosaicing not in DEMOSAICERS:
        raise ValueError('Unsupported demosaicing method!')
    dev = resolve_device(device)
    mosaic, cfa, cam2srgb, cam_mul = _load_raw_data(filename)
    mosaic = _apply_wb(mosaic, cfa, cam_mul)
    rgb = develop(mosaic, cfa, cam2srgb if use_srgb else None, brightness=brightness,
                  use_gamma=use_gamma, demosaicing=demosaicing, device=dev)
    return rgb[None] if expand else rgb


def process_auto(filename, device='cuda'):
    """The reference's development without rawpy: ``process`` with no
    brightness correction, as uint8 numpy (h, w, 3)."""
    return to_uint8(process(filename, brightness=None, device=device))


# Re-export the Bayer helpers under the reference's module-level names.
stack_bayer = bayer.stack_bayer
simulate_bayer = bayer.simulate_bayer
merge_bayer = bayer.merge_bayer
